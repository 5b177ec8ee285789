"""The engine's traversal methods (``ssg``, ``triangulation``,
``hybrid_expansion``) against the JAX engine on one corpus, on the CPU.

Fused results agree as in test_torch_engine (scores within 1e-5, 1e-4 on
an int8 store; keys, counts and rep rows equal, tied keys as sets).  The
``details`` arrays must equal the JAX engine's record for record, in its
order: (slot, query, anchor) where the traversal is windowed, (query,
slot, anchor) where it falls back to full-corpus hops; scores within the
tolerance, rows equal for the walkers whose choices are clear of ties
(test_torch_traversal's rule, at most 1% left out).  ``materialize_details``
dicts are compared with scores rounded to 4 places.

Each tier gets a configuration of its own (``top_n`` differs): the JAX
engine reads its cap when it traces, and a cached trace of another tier
would otherwise answer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rag_challenge_2_tpu.retrieval.engine as jax_engine_mod
import rag_challenge_2_tpu_torch.retrieval.engine as engine_mod
from rag_challenge_2_tpu.index import build_corpus_index as jax_build
from rag_challenge_2_tpu.index.store import quantize_index as jax_quantize_index
from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu.retrieval.engine import QueryEngine as JaxEngine
from rag_challenge_2_tpu.retrieval.engine import SearchConfig as JaxCfg
from rag_challenge_2_tpu_torch.index import load_index
from rag_challenge_2_tpu_torch.retrieval import QueryEngine, SearchConfig
from tests.conftest import make_reports
from tests.test_torch_engine import _q_for, assert_same_results
from tests.test_torch_traversal import clear_anchors

METHODS = ("ssg", "triangulation", "hybrid_expansion")
TIERS = ("windowed", "sequential", "capped", "window0")
OPTIONS = {
    "dense": {},
    "bm25": dict(use_bm25=True, bm25_top_k=12),
    "parent_pages": dict(return_parent_pages=True),
    "bm25_pages_sum": dict(use_bm25=True, bm25_top_k=12, return_parent_pages=True,
                           fuse_mode="sum", dense_weight=0.5),
}
TEXTS = ["营业收入 chunk5", "页面3 chunk7 金盘科技"]


@pytest.fixture(scope="module", autouse=True)
def drop_compiled_programs():
    """Every tier and option compiles the JAX engine anew.  Drop the
    compiled programs once this module is done, so that the process which
    runs the next test file does not carry hundreds of them."""
    yield
    jax.clear_caches()


def make_engines(tmp_path, store="float32", **corpus):
    reports, embs = make_reports(np.random.default_rng(0), **corpus)
    idx, meta = jax_build(reports, embs, vocab_bits=16,
                          **({"dtype": jnp.bfloat16} if store == "bfloat16" else {}))
    if store == "int8":
        idx = jax_quantize_index(idx)
    jax_save(tmp_path / "idx.npz", idx, meta)
    tidx, tmeta = load_index(tmp_path / "idx.npz", device="cpu")
    return JaxEngine(idx, meta), QueryEngine(tidx, tmeta), embs


def set_tier(je, te, tier, monkeypatch):
    """Put both engines into one tier of the traversal decision; returns
    whether the walkers come in (slot, query, anchor) order."""
    one_window = te.window * te.index.dim * te.index.emb.element_size()
    if tier == "window0":
        je.window = te.window = 0
    elif tier != "windowed":
        cap = one_window if tier == "sequential" else 0
        monkeypatch.setattr(jax_engine_mod, "TRAVERSAL_WINDOW_COPY_CAP", cap)
        monkeypatch.setattr(engine_mod, "TRAVERSAL_WINDOW_COPY_CAP", cap)
    return tier in ("windowed", "sequential")


def rounded(o):
    if isinstance(o, float):
        return round(o, 4)
    if isinstance(o, dict):
        return {k: rounded(v) for k, v in o.items()}
    if isinstance(o, list):
        return [rounded(v) for v in o]
    return o


def assert_same_details(td, jd, tol, where):
    assert td.keys() == jd.keys()
    for name in td:
        if name in ("trav", "ssg", "tri"):
            mode = "ssg" if name == "ssg" or "ssg" in where else "triangulation"
            ok = clear_anchors(jd[name], mode == "ssg")
            assert (~ok).sum() <= 0.01 * ok.size, (where, name, int((~ok).sum()))
            for f in ("path", "valid", "cand_ids"):
                np.testing.assert_array_equal(
                    getattr(td[name], f).numpy()[ok],
                    np.asarray(getattr(jd[name], f))[ok], err_msg=f"{where} {name}.{f}")
            for f in ("hop_score", "cand_scores"):
                np.testing.assert_allclose(
                    getattr(td[name], f).numpy()[ok],
                    np.asarray(getattr(jd[name], f))[ok], rtol=tol, atol=tol,
                    err_msg=f"{where} {name}.{f}")
        elif name == "basic_sims":
            np.testing.assert_allclose(td[name].numpy(), np.asarray(jd[name]),
                                       rtol=tol, atol=tol)
        elif name == "basic_rows":
            ok = np.asarray(jd["basic_ok"])
            np.testing.assert_array_equal(td[name].numpy()[ok], np.asarray(jd[name])[ok])
        else:                                          # trav_qids, basic_ok
            np.testing.assert_array_equal(td[name].numpy(), np.asarray(jd[name]),
                                          err_msg=f"{where} {name}")


def both_search(je, te, q, kw, years=None):
    jc, tc = JaxCfg(**kw), SearchConfig(**kw)
    jcands, jd = je.search(q, "金盘科技", "营业收入", years, jc, query_texts=TEXTS,
                           with_details=True)
    tcands, td = te.search(q, "金盘科技", "营业收入", years, tc, query_texts=TEXTS,
                           with_details=True)
    return (jc, jcands, jd), (tc, tcands, td)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("method", METHODS)
def test_traversal_search_matches_jax(tmp_path, rng, monkeypatch, method, tier, option):
    je, te, embs = make_engines(tmp_path)
    set_tier(je, te, tier, monkeypatch)
    kw = dict(method=method, top_k=5, top_n=60 + TIERS.index(tier), max_hops=3,
              neighbor_k=5, **OPTIONS[option])
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    for years in (None, [2024]):
        (jc, jcands, jd), (tc, tcands, td) = both_search(je, te, q, kw, years)
        tres, jres = te.materialize(tcands, tc), je.materialize(jcands, jc)
        assert tres
        assert_same_results(tres, jres, kw.get("return_parent_pages", False))
        assert_same_details(td, jd, 1e-5, f"{method} {tier} {option}")
        assert rounded(te.materialize_details(td, tc)) == \
            rounded(je.materialize_details(jd, jc))


@pytest.mark.parametrize("route", ["plain", "wide"])
@pytest.mark.parametrize("method", ["ssg", "hybrid_expansion"])
def test_traversal_neighbor_k_100_matches_jax(tmp_path, rng, monkeypatch, method, route):
    """neighbor_k = 100: 101 candidates a hop, above the 64 kernels K1 and
    K3 keep, over documents of 160 chunks.  "wide" sends the CPU hops down
    the route the card takes for them (``ops.topk.wide_topk``)."""
    from rag_challenge_2_tpu_torch.ops import topk as topk_mod

    if route == "wide":
        real = topk_mod.topk_route
        monkeypatch.setattr(topk_mod, "topk_route",
                            lambda k, dtype, device: real(k, dtype, "cuda"))
    je, te, embs = make_engines(tmp_path, pages_per_doc=20, chunks_per_page=8)
    kw = dict(method=method, top_k=5, top_n=70, max_hops=3, neighbor_k=100)
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    (jc, jcands, jd), (tc, tcands, td) = both_search(je, te, q, kw)
    tres, jres = te.materialize(tcands, tc), je.materialize(jcands, jc)
    assert tres
    assert_same_results(tres, jres, False)
    assert_same_details(td, jd, 1e-5, f"{method} neighbor_k 100 {route}")
    assert rounded(te.materialize_details(td, tc)) == \
        rounded(je.materialize_details(jd, jc))


@pytest.mark.parametrize("tier", TIERS)
def test_details_order_follows_the_tier(tmp_path, rng, monkeypatch, tier):
    """Walkers come slot-major where the JAX engine's traversal is windowed
    and query-major where it is not, and materialize_details shows it.  The
    cap decides that order alone: a windowed corpus walks views of the
    store whatever the cap, only ``window == 0`` hops under row masks."""
    je, te, embs = make_engines(tmp_path)
    slot_major = set_tier(je, te, tier, monkeypatch)
    cfg = SearchConfig(method="ssg", top_k=5, top_n=40, max_hops=2, neighbor_k=5)
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    calls = []
    for name in ("traverse_windowed", "traverse"):
        def counted(*a, _real=getattr(engine_mod, name), _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(engine_mod, name, counted)
    _, d = te.search(q, "金盘科技", cfg=cfg, with_details=True)
    assert set(calls) == {"traverse" if tier == "window0" else "traverse_windowed"}
    Q, M = cfg.max_queries, cfg.max_docs
    want = (np.tile(np.arange(Q), M) if slot_major else np.repeat(np.arange(Q), M))
    np.testing.assert_array_equal(d["trav_qids"].numpy(), want)
    info = te.materialize_details(d, cfg)["retrieval_details"]
    anchors = [t["anchor"]["idx"] for t in info["traversal_info"]]
    # 2 queries x 2 routed docs of 12 rows: the anchors' documents
    docs = [a // 12 for a in anchors]
    assert docs == ([0, 0, 1, 1] if slot_major else [0, 1, 0, 1])
    assert info["method"] == "ssg" and info["max_hops"] == 2


@pytest.mark.parametrize("store", ["bfloat16", "int8"])
@pytest.mark.parametrize("tier", ["windowed", "window0"])
@pytest.mark.parametrize("method", METHODS)
def test_traversal_over_bf16_and_int8_stores(tmp_path, rng, monkeypatch, method,
                                             tier, store):
    je, te, embs = make_engines(tmp_path, store)
    assert str(te.index.emb.dtype) == f"torch.{store}"
    set_tier(je, te, tier, monkeypatch)
    tol = 1e-4 if store == "int8" else 1e-5
    kw = dict(method=method, top_k=5, top_n=70 + TIERS.index(tier), max_hops=3,
              neighbor_k=5, use_bm25=True, bm25_top_k=12)
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    (jc, jcands, jd), (tc, tcands, td) = both_search(je, te, q, kw)
    assert_same_results(te.materialize(tcands, tc), je.materialize(jcands, jc))
    assert_same_details(td, jd, tol, f"{method} {tier} {store}")
    assert rounded(te.materialize_details(td, tc)) == \
        rounded(je.materialize_details(jd, jc))


@pytest.mark.parametrize("tier", ["windowed", "window0"])
def test_hybrid_expansion_with_use_ivf(tmp_path, rng, monkeypatch, tier):
    """use_ivf serves the basic block (and so the anchors) through the
    probe; the hops stay exact.  Both engines share one IVFIndex."""
    from rag_challenge_2_tpu.index.store import save_ivf as jax_save_ivf
    from rag_challenge_2_tpu_torch.index import load_ivf

    je, te, embs = make_engines(tmp_path)
    jax_save_ivf(tmp_path / "idx.ivf.npz", je.build_ivf(iters=5))
    te.ivf = load_ivf(tmp_path / "idx.ivf.npz", device="cpu")
    set_tier(je, te, tier, monkeypatch)
    kw = dict(method="hybrid_expansion", top_k=5, top_n=80 + TIERS.index(tier),
              max_hops=3, neighbor_k=5, use_ivf=True, use_bm25=True, bm25_top_k=12)
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    (jc, jcands, jd), (tc, tcands, td) = both_search(je, te, q, kw)
    assert_same_results(te.materialize(tcands, tc), je.materialize(jcands, jc))
    assert_same_details(td, jd, 1e-5, f"hybrid ivf {tier}")
    with pytest.raises(ValueError, match="build_ivf"):
        QueryEngine(te.index, te.meta).search(q, "金盘科技", cfg=tc)


def _many_requests(embs, rng, R):
    qs, texts = [], []
    for r in range(R):
        n = 1 + r % 3                              # 1..3 queries per request
        qs.append(np.concatenate([_q_for(embs, r % 2, (3 * r + i) % 12, rng)
                                  for i in range(n)]))
        texts.append([f"chunk{(3 * r + i) % 12} 营业收入" for i in range(n)])
    return qs, texts


@pytest.mark.parametrize("R", [1, 3, 5])
@pytest.mark.parametrize("tier", ["windowed", "window0"])
@pytest.mark.parametrize("method", METHODS)
def test_traversal_search_many_equals_searches_and_jax(tmp_path, rng, monkeypatch,
                                                       method, tier, R):
    je, te, embs = make_engines(tmp_path)
    set_tier(je, te, tier, monkeypatch)
    kw = dict(method=method, top_k=5, top_n=90 + TIERS.index(tier), max_hops=3,
              neighbor_k=5, use_bm25=True, bm25_top_k=12)
    jc, tc = JaxCfg(**kw), SearchConfig(**kw)
    qs, texts = _many_requests(embs, rng, R)
    many = te.search_many(qs, "金盘科技", "营业收入", None, tc, query_texts_list=texts)
    jmany = je.search_many(qs, "金盘科技", "营业收入", None, jc, query_texts_list=texts)
    assert len(many) == R
    for r in range(R):
        one = te.search(qs[r], "金盘科技", "营业收入", None, tc, query_texts=texts[r])
        got = te.materialize(many[r], tc)
        assert_same_results(got, te.materialize(one, tc))
        assert_same_results(got, je.materialize(jmany[r], jc))


def test_planted_neighbours_are_reached(tmp_path):
    """A chain of near-duplicates of one chunk: ssg from that chunk walks
    the chain, and hybrid_expansion reports the chain's far end as new."""
    rng = np.random.default_rng(3)
    reports, embs = make_reports(rng, n_docs=2, companies=("金盘科技",) * 2,
                                 years=(2023, 2024), pages_per_doc=20, dim=64)
    base = embs[0][4].copy()
    chain = [4, 30, 41, 52]
    for step, row in enumerate(chain[1:], 1):
        # each link is closer to the next than to the one before the last:
        # similarity along the chain rises, so SSG keeps stepping
        v = base + (0.5 - 0.12 * step) * rng.normal(size=64) / 8
        embs[0][row] = (v / np.linalg.norm(v)).astype(np.float32)
    from rag_challenge_2_tpu_torch.index import build_corpus_index

    idx, meta = build_corpus_index(reports, embs, vocab_bits=16, device="cpu")
    te = QueryEngine(idx, meta)
    cfg = SearchConfig(method="ssg", top_k=5, top_n=30, max_hops=4, neighbor_k=10)
    cands, d = te.search(embs[0][4][None], "金盘科技", selected_years=[2023], cfg=cfg,
                         with_details=True)
    path = d["trav"].path[d["trav"].path[:, 0] == 4][0].tolist()
    assert path[0] == 4 and set(path[1:]) & set(chain[1:])
    rows = {r["rep_row"] for r in te.materialize(cands, cfg)}
    assert set(p for p in path if p >= 0) <= rows


def test_hops_go_through_dense_topk(tmp_path, rng, monkeypatch):
    """On an f32 store every hop of the windowed and of the full-corpus
    tier is a dense_topk call with a row-shared mask (the path that
    launches K1 / K3 on the card); an int8 store's hops never are."""
    import rag_challenge_2_tpu_torch.retrieval.traversal as tv

    calls = []
    real = tv.dense_topk

    def spy(q, emb, k, mask=None, **kw):
        calls.append((q.shape[0], emb.shape[0], k, None if mask is None else mask.dim()))
        return real(q, emb, k, mask=mask, **kw)

    monkeypatch.setattr(tv, "dense_topk", spy)
    je, te, embs = make_engines(tmp_path)
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    cfg = SearchConfig(method="hybrid_expansion", top_k=5, top_n=30, max_hops=3,
                       neighbor_k=5)
    te.search(q, "金盘科技", cfg=cfg)
    Q = cfg.max_queries
    # 2 routed slots x (3 ssg hops of Q*10 walkers + 3 tri hops of Q*20), 12-row views
    assert sorted(calls) == sorted(
        [(Q * 10, 12, 6, None)] * 6 + [(Q * 20, 12, 6, None)] * 6)
    calls.clear()
    te.window = 0
    te.search(q, "金盘科技", cfg=cfg)
    n_pad = te.index.n_pad
    assert sorted(calls) == sorted(
        [(Q * 10, n_pad, 6, 1)] * 6 + [(Q * 20, n_pad, 6, 1)] * 6)
    calls.clear()
    _, te8, _ = make_engines(tmp_path, "int8")
    te8.search(q, "金盘科技", cfg=cfg)
    assert calls == []


def test_unknown_method_raises_value_error(tmp_path, rng):
    _, te, embs = make_engines(tmp_path)
    q = _q_for(embs, 0, 0, rng)
    for call in (lambda c: te.search(q, "金盘科技", cfg=c),
                 lambda c: te.search_many([q], "金盘科技", cfg=c)):
        with pytest.raises(ValueError, match="unknown method"):
            call(SearchConfig(method="graph"))
    assert te.materialize_details({}, SearchConfig()) == {
        "retrieval_details": None, "algorithm_contribution": None}
    cands, d = te.search(q, "金盘科技", cfg=SearchConfig(top_k=3), with_details=True)
    assert d == {} and (cands.key >= 0).any()
    assert torch.is_tensor(cands.key)
