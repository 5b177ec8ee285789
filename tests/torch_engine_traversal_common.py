"""What the split traversal-engine tests share: the engines, the tiers of
the traversal decision, the comparisons, and the bodies of the tests that
are split by method across ``tests/test_torch_engine_traversal_*.py``.

The engine's traversal methods (``ssg``, ``triangulation``,
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
would otherwise answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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


def _many_requests(embs, rng, R):
    qs, texts = [], []
    for r in range(R):
        n = 1 + r % 3                              # 1..3 queries per request
        qs.append(np.concatenate([_q_for(embs, r % 2, (3 * r + i) % 12, rng)
                                  for i in range(n)]))
        texts.append([f"chunk{(3 * r + i) % 12} 营业收入" for i in range(n)])
    return qs, texts


def traversal_search_matches_jax(tmp_path, rng, monkeypatch, method, tier, option):
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


def traversal_neighbor_k_100_matches_jax(tmp_path, rng, monkeypatch, method, route):
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


def traversal_over_bf16_and_int8_stores(tmp_path, rng, monkeypatch, method,
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


def traversal_search_many_equals_searches_and_jax(tmp_path, rng, monkeypatch,
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
