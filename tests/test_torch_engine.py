"""The slice as a whole: a corpus built and saved by the JAX package,
loaded by the port, searched by both engines on the same query
embeddings and texts, results compared field by field.

Scores agree within 1e-5 (dense: f32 products summed in other orders;
BM25: the reference's f32 cumsum totals).  Keys, hit and method counts
and rep rows must match; where scores tie within that tolerance the
order inside the tie is free, so tied keys compare as sets.  top_n is
set above the number of candidates, and bm25_top_k to a document's chunk
count, wherever BM25 ties (the fixture's chunks share most terms) could
fall on a cut-off; tie order at the BM25 cut-off is held to the oracle
in test_torch_bm25."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.index import build_corpus_index as jax_build
from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu.retrieval.engine import QueryEngine as JaxEngine
from rag_challenge_2_tpu.retrieval.engine import SearchConfig as JaxCfg
from rag_challenge_2_tpu_torch.index import load_index, save_index
from rag_challenge_2_tpu_torch.retrieval import (
    QueryEngine, SearchConfig, extract_years_from_question, route_mask)
from tests.conftest import make_reports

TOL = 1e-5
FIELDS = ("hit_count", "method_count", "rep_row", "page", "source_sha1",
          "source_year", "text")


def _q_for(embs, doc, row, rng, noise=0.01):
    q = embs[doc][row] + noise * rng.normal(size=embs[doc].shape[1])
    return (q / np.linalg.norm(q)).astype(np.float32)[None, :]


def assert_same_results(tres, jres, parent_pages=False):
    assert len(tres) == len(jres)
    ts = np.array([r["distance"] for r in tres])
    js = np.array([r["distance"] for r in jres])
    np.testing.assert_allclose(ts, js, rtol=TOL, atol=TOL)
    np.testing.assert_allclose([r["base_similarity"] for r in tres],
                               [r["base_similarity"] for r in jres],
                               rtol=TOL, atol=TOL)

    def ident(r):
        return (r["source_sha1"], r["page"]) if parent_pages else r["rep_row"]

    i = 0
    while i < len(js):                     # walk groups of tied scores
        j = i + 1
        while j < len(js) and abs(js[j] - js[j - 1]) <= 2 * TOL:
            j += 1
        tg = {ident(r): r for r in tres[i:j]}
        jg = {ident(r): r for r in jres[i:j]}
        assert tg.keys() == jg.keys(), (i, j, tg.keys(), jg.keys())
        for k in tg:
            for f in FIELDS:
                assert tg[k][f] == jg[k][f], (k, f)
        i = j


@pytest.fixture
def engines(tiny_corpus, tmp_path):
    idx, meta, reports, embs = tiny_corpus
    jax_save(tmp_path / "idx.npz", idx, meta)
    tidx, tmeta = load_index(tmp_path / "idx.npz", device="cpu")
    return JaxEngine(idx, meta), QueryEngine(tidx, tmeta), embs


CONFIGS = {
    "basic": dict(top_k=5, top_n=10),
    "basic_bm25": dict(top_k=5, top_n=40, use_bm25=True, bm25_top_k=12),
    "bm25_sum": dict(top_k=5, top_n=40, use_bm25=True, bm25_top_k=12,
                     fuse_mode="sum"),
    "bm25_weighted": dict(top_k=5, top_n=40, use_bm25=True, bm25_top_k=12,
                          dense_weight=0.5),
    "sum_weighted": dict(top_k=8, top_n=40, use_bm25=True, bm25_top_k=12,
                         fuse_mode="sum", dense_weight=0.5),
    "parent_pages": dict(top_k=5, top_n=40, use_bm25=True, bm25_top_k=12,
                         return_parent_pages=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_search_matches_jax(engines, rng, name):
    je, te, embs = engines
    kw = CONFIGS[name]
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    texts = ["营业收入 chunk5", "页面3 chunk7 金盘科技"]
    for years in (None, [2024]):
        jc, tc = JaxCfg(**kw), SearchConfig(**kw)
        jres = je.materialize(je.search(q, "金盘科技", "营业收入", years, jc,
                                        query_texts=texts), jc)
        tres = te.materialize(te.search(q, "金盘科技", "营业收入", years, tc,
                                        query_texts=texts), tc)
        assert tres
        assert_same_results(tres, jres, kw.get("return_parent_pages", False))


def test_ragged_corpus_takes_the_full_scan_branch(tmp_path):
    """One huge doc + tiny docs: M * window > 2N sends pair_topk to the
    masked full-scan branch; the windowed engine and the JAX engine agree."""
    reports, embs = [], []
    for d, n_pages in enumerate((300, 1, 1)):
        r, e = make_reports(
            np.random.default_rng(d), n_docs=1, companies=("金盘科技",),
            years=(2022 + d,), pages_per_doc=n_pages)
        r[0]["metainfo"]["sha1_name"] = f"J{2022+d}_doc{d}"
        reports.append(r[0])
        embs.append(e[0])
    idx, meta = jax_build(reports, embs, vocab_bits=16)
    jax_save(tmp_path / "ragged.npz", idx, meta)
    tidx, tmeta = load_index(tmp_path / "ragged.npz", device="cpu")
    je, te = JaxEngine(idx, meta), QueryEngine(tidx, tmeta)
    assert te.window == je.window and 3 * te.window > 2 * tidx.n_pad
    rng = np.random.default_rng(7)
    q = np.concatenate([_q_for(embs, 0, 17, rng), _q_for(embs, 2, 1, rng)])
    for use_bm25 in (False, True):
        kw = dict(top_k=5, top_n=100, max_docs=3, use_bm25=use_bm25,
                  bm25_top_k=5)
        jc, tc = JaxCfg(**kw), SearchConfig(**kw)
        jres = je.materialize(je.search(q, "金盘科技", cfg=jc,
                                        query_texts=["chunk17", "chunk1"]), jc)
        tres = te.materialize(te.search(q, "金盘科技", cfg=tc,
                                        query_texts=["chunk17", "chunk1"]), tc)
        assert_same_results(tres, jres)
        assert 17 in [r["rep_row"] for r in tres[:5]]


@pytest.mark.parametrize("windowed", [True, False])
def test_windowed_and_full_scan_branches_agree(engines, rng, windowed):
    """Forcing the full-scan branch on a contiguous corpus changes nothing."""
    je, te, embs = engines
    q = _q_for(embs, 0, 5, rng)
    cfg = SearchConfig(top_k=5, top_n=10)
    if not windowed:
        te.window = 0
    res = te.materialize(te.search(q, "金盘科技", cfg=cfg), cfg)
    jres = je.materialize(je.search(q, "金盘科技", cfg=JaxCfg(top_k=5, top_n=10)),
                          JaxCfg(top_k=5, top_n=10))
    assert_same_results(res, jres)
    assert res[0]["rep_row"] == 5


# ---- the verify-skill probes -------------------------------------------

def test_unknown_company_raises(engines, rng):
    _, te, embs = engines
    with pytest.raises(ValueError, match="No report found"):
        te.search(_q_for(embs, 0, 0, rng), "不存在公司", cfg=SearchConfig())
    assert not route_mask(te.index, te.meta.company_id("不存在公司")).any()


def test_year_miss_falls_back_to_company(engines, rng):
    je, te, embs = engines
    q = _q_for(embs, 0, 3, rng)
    cfg = SearchConfig(top_k=5, top_n=10)
    years = extract_years_from_question("2019年营业收入")
    assert years == [2018, 2019, 2020]
    assert te.routed_docs("金盘科技", selected_years=years) == \
        te.routed_docs("金盘科技") == [0, 1]
    res = te.materialize(te.search(q, "金盘科技", selected_years=years, cfg=cfg), cfg)
    jc = JaxCfg(top_k=5, top_n=10)
    jres = je.materialize(je.search(q, "金盘科技", selected_years=years, cfg=jc), jc)
    assert_same_results(res, jres)
    assert res[0]["rep_row"] == 3


def test_k_larger_than_routed_rows(engines, rng):
    """top_k beyond the routed rows returns only routed rows."""
    je, te, embs = engines
    q = _q_for(embs, 1, 2, rng)
    kw = dict(top_k=20, top_n=60)
    res = te.materialize(te.search(q, "金盘科技", selected_years=[2024],
                                   cfg=SearchConfig(**kw)), SearchConfig(**kw))
    assert len(res) == 12 and all(r["source_year"] == 2024 for r in res)
    jres = je.materialize(je.search(q, "金盘科技", selected_years=[2024],
                                    cfg=JaxCfg(**kw)), JaxCfg(**kw))
    assert_same_results(res, jres)


def test_empty_bm25_query_adds_no_hits(engines, rng):
    _, te, embs = engines
    q = _q_for(embs, 0, 5, rng)
    base = SearchConfig(top_k=5, top_n=40)
    hyb = SearchConfig(top_k=5, top_n=40, use_bm25=True)
    r0 = te.materialize(te.search(q, "金盘科技", cfg=base), base)
    r1 = te.materialize(te.search(q, "金盘科技", cfg=hyb, query_texts=["?!"]), hyb)
    assert [r["rep_row"] for r in r1] == [r["rep_row"] for r in r0]
    assert all(r["method_count"] == 1 for r in r1)


def test_save_load_round_trip_gives_identical_hits(engines, rng, tmp_path):
    _, te, embs = engines
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 2, rng)])
    cfg = SearchConfig(top_k=5, top_n=20, use_bm25=True)
    r0 = te.materialize(te.search(q, "金盘科技", cfg=cfg, query_texts=["chunk5"]), cfg)
    save_index(tmp_path / "again.npz", te.index, te.meta)
    idx2, meta2 = load_index(tmp_path / "again.npz", device="cpu")
    te2 = QueryEngine(idx2, meta2)
    r1 = te2.materialize(te2.search(q, "金盘科技", cfg=cfg, query_texts=["chunk5"]), cfg)
    assert r0 == r1


def test_tensor_query_embeddings_and_bf16_store(engines, rng, tmp_path):
    """Query embeddings may be tensors; a bf16 store searches in f32."""
    _, te, embs = engines
    reports, embs2 = make_reports(np.random.default_rng(0))
    idx, meta = jax_build(reports, embs2, vocab_bits=16, dtype=jnp.bfloat16)
    jax_save(tmp_path / "bf16.npz", idx, meta)
    tidx, tmeta = load_index(tmp_path / "bf16.npz", device="cpu")
    eng = QueryEngine(tidx, tmeta)
    q = _q_for(embs2, 0, 5, rng)
    cfg = SearchConfig(top_k=5, top_n=10)
    a = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    b = eng.materialize(eng.search(torch.from_numpy(q), "金盘科技", cfg=cfg), cfg)
    assert a == b and a[0]["rep_row"] == 5
    je = JaxEngine(idx, meta)
    jres = je.materialize(je.search(q, "金盘科技", cfg=JaxCfg(top_k=5, top_n=10)),
                          JaxCfg(top_k=5, top_n=10))
    assert_same_results(a, jres)


@pytest.mark.parametrize("kw,item", [
    # IVF is ported: use_ivf without an IVFIndex is refused, as in the
    # reference's engine
    (dict(use_ivf=True), "build_ivf"),
], ids=["kw3-A.12"])
def test_unported_options_raise(engines, rng, kw, item):
    _, te, embs = engines
    with pytest.raises(ValueError, match=item):
        te.search(_q_for(embs, 0, 0, rng), "金盘科技", cfg=SearchConfig(**kw))


def test_unported_engine_features_raise(engines, rng):
    """The sharded engine (hier=, tests/test_torch_sharded_*.py) serves
    the basic method; traversal on a row-sharded store is not ported
    (ROADMAP A.14f), and its IVF is built per shard."""
    _, te, embs = engines
    sharded = QueryEngine(te.index, te.meta, hier=object())
    for method in ("ssg", "triangulation", "hybrid_expansion"):
        with pytest.raises(NotImplementedError, match="A.14f"):
            sharded.search(_q_for(embs, 0, 0, rng), "金盘科技",
                           cfg=SearchConfig(method=method))
    with pytest.raises(NotImplementedError, match="build_sharded_ivf"):
        sharded.build_ivf(n_clusters=4, iters=2)
    ivf = QueryEngine(te.index, te.meta).build_ivf(n_clusters=4, iters=2)
    assert QueryEngine(te.index, te.meta, ivf=ivf).ivf is ivf


# ---- the IVF probe arm (use_ivf) ----------------------------------------

IVF_CONFIGS = {
    "ivf": dict(top_k=5, top_n=10, use_ivf=True),
    "ivf_bm25": dict(top_k=5, top_n=40, use_ivf=True, use_bm25=True, bm25_top_k=12),
    "ivf_bm25_sum": dict(top_k=5, top_n=40, use_ivf=True, use_bm25=True,
                         bm25_top_k=12, fuse_mode="sum", dense_weight=0.5),
    "ivf_nprobe2": dict(top_k=8, top_n=40, use_ivf=True, ivf_nprobe=2),
}


@pytest.fixture
def ivf_engines(engines, tmp_path):
    """Both engines over one IVF, built by JAX and carried to the port
    through the sidecar, so k-means stays out of the comparison."""
    from rag_challenge_2_tpu.index.store import save_ivf as jax_save_ivf
    from rag_challenge_2_tpu_torch.index import load_ivf

    je, te, embs = engines
    jax_save_ivf(tmp_path / "idx.ivf.npz", je.build_ivf(iters=5))
    te.ivf = load_ivf(tmp_path / "idx.ivf.npz", device="cpu")
    return je, te, embs


@pytest.mark.parametrize("mode", ["win_start", "mask", "pair_doc"])
@pytest.mark.parametrize("name", list(IVF_CONFIGS))
def test_ivf_search_matches_jax(ivf_engines, rng, name, mode):
    je, te, embs = ivf_engines
    if mode == "pair_doc":
        je, te = je.cluster_order(), te.cluster_order()
        assert te.window == 0 and te.ivf.cluster_doc is not None
    elif mode == "mask":
        je.window = te.window = 0
    else:
        assert te.window > 0 and te.ivf.list_row_min is not None
    kw = IVF_CONFIGS[name]
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    texts = ["营业收入 chunk5", "页面3 chunk7 金盘科技"]
    for years in (None, [2024]):
        jc, tc = JaxCfg(**kw), SearchConfig(**kw)
        jres = je.materialize(je.search(q, "金盘科技", "营业收入", years, jc,
                                        query_texts=texts), jc)
        tres = te.materialize(te.search(q, "金盘科技", "营业收入", years, tc,
                                        query_texts=texts), tc)
        assert tres
        assert_same_results(tres, jres)
        routed = {te.meta.docs[d].sha1 for d in te.routed_docs("金盘科技", "", years)}
        assert all(r["source_sha1"] in routed for r in tres)


@pytest.mark.parametrize("order", [False, True])
def test_ivf_arm_over_an_int8_corpus(tiny_corpus, tmp_path, rng, order):
    """An int8 corpus is dequantized for clustering (f32 probe store);
    cluster_order() re-quantizes the IVF so the corpus keeps int8."""
    from rag_challenge_2_tpu.index.store import quantize_index
    from rag_challenge_2_tpu.index.store import save_ivf as jax_save_ivf
    from rag_challenge_2_tpu_torch.index import load_ivf

    idx, meta, _, embs = tiny_corpus
    idx8 = quantize_index(idx)
    jax_save(tmp_path / "i8.npz", idx8, meta)
    tidx, tmeta = load_index(tmp_path / "i8.npz", device="cpu")
    je, te = JaxEngine(idx8, meta), QueryEngine(tidx, tmeta)
    assert te.index.emb.dtype == torch.int8
    jax_save_ivf(tmp_path / "i8.ivf.npz", je.build_ivf(iters=5))
    te.ivf = load_ivf(tmp_path / "i8.ivf.npz", device="cpu")
    assert te.ivf.emb_perm.dtype == torch.float32
    if order:
        je, te = je.cluster_order(), te.cluster_order()
        assert te.ivf.emb_perm.dtype == torch.int8 and te.index.emb is te.ivf.emb_perm
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    kw = dict(top_k=5, top_n=40, use_ivf=True, use_bm25=True, bm25_top_k=12)
    jc, tc = JaxCfg(**kw), SearchConfig(**kw)
    jres = je.materialize(je.search(q, "金盘科技", "营业收入", cfg=jc,
                                    query_texts=["chunk5", "chunk7"]), jc)
    tres = te.materialize(te.search(q, "金盘科技", "营业收入", cfg=tc,
                                    query_texts=["chunk5", "chunk7"]), tc)
    assert tres
    assert_same_results(tres, jres)


def test_ivf_search_finds_the_planted_chunk(ivf_engines, rng):
    _, te, embs = ivf_engines
    cfg = SearchConfig(top_k=5, top_n=10, use_ivf=True)
    res = te.materialize(te.search(_q_for(embs, 1, 4, rng), "金盘科技",
                                   selected_years=[2024], cfg=cfg), cfg)
    assert res[0]["rep_row"] == 12 + 4


# ---- the int8 store (quantize_index) and scan_rt ---------------------------

@pytest.fixture
def int8_engines(tiny_corpus, tmp_path):
    """Both engines over the JAX package's int8 variant of the corpus,
    carried to the port through the npz."""
    from rag_challenge_2_tpu.index.store import quantize_index as jax_quantize_index

    idx, meta, _, embs = tiny_corpus
    idx8 = jax_quantize_index(idx)
    jax_save(tmp_path / "i8.npz", idx8, meta)
    tidx, tmeta = load_index(tmp_path / "i8.npz", device="cpu")
    assert tidx.emb.dtype == torch.int8 and tidx.emb_scale is not None
    return JaxEngine(idx8, meta), QueryEngine(tidx, tmeta), embs


INT8_CONFIGS = {
    "basic": dict(top_k=5, top_n=10),
    "bm25": dict(top_k=5, top_n=40, use_bm25=True, bm25_top_k=12),
    "bm25_sum": dict(top_k=8, top_n=40, use_bm25=True, bm25_top_k=12,
                     fuse_mode="sum", dense_weight=0.5),
    "scan_rt": dict(top_k=5, top_n=40, use_bm25=True, bm25_top_k=12, scan_rt=0.95),
}


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("name", list(INT8_CONFIGS))
def test_int8_store_search_matches_jax(int8_engines, rng, name, windowed):
    """The int8 arm of dense_hits in both branches: per-slot row ranges
    (windowed) and the masked full scan."""
    je, te, embs = int8_engines
    if not windowed:
        je.window = te.window = 0
    kw = INT8_CONFIGS[name]
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    texts = ["营业收入 chunk5", "页面3 chunk7 金盘科技"]
    for years in (None, [2024]):
        jc, tc = JaxCfg(**kw), SearchConfig(**kw)
        jres = je.materialize(je.search(q, "金盘科技", "营业收入", years, jc,
                                        query_texts=texts), jc)
        tres = te.materialize(te.search(q, "金盘科技", "营业收入", years, tc,
                                        query_texts=texts), tc)
        assert tres
        assert_same_results(tres, jres)


def test_port_quantize_index_serves_like_the_jax_int8_index(engines, int8_engines, rng):
    from rag_challenge_2_tpu_torch.index import quantize_index

    _, te, embs = engines
    _, te8, _ = int8_engines
    eng = QueryEngine(quantize_index(te.index), te.meta)
    cfg = SearchConfig(top_k=5, top_n=20, use_bm25=True)
    q = _q_for(embs, 1, 2, rng)
    a = eng.materialize(eng.search(q, "金盘科技", cfg=cfg, query_texts=["chunk2"]), cfg)
    b = te8.materialize(te8.search(q, "金盘科技", cfg=cfg, query_texts=["chunk2"]), cfg)
    assert a and a == b


def test_scan_rt_is_exact(engines, rng):
    """scan_rt is accepted (the JAX engine's approximate large-window mode)
    and the scan stays exact: the results equal scan_rt=None's."""
    je, te, embs = engines
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)])
    base = dict(top_k=5, top_n=30, use_bm25=True, bm25_top_k=12)
    r0 = te.materialize(te.search(q, "金盘科技", cfg=SearchConfig(**base),
                                  query_texts=["chunk5"]), SearchConfig(**base))
    rt = SearchConfig(**base, scan_rt=0.9)
    r1 = te.materialize(te.search(q, "金盘科技", cfg=rt, query_texts=["chunk5"]), rt)
    assert r0 == r1
    jc = JaxCfg(**base, scan_rt=0.9)
    jres = je.materialize(je.search(q, "金盘科技", cfg=jc, query_texts=["chunk5"]), jc)
    assert_same_results(r1, jres)


# ---- search_many: R requests sharing one route ------------------------------

MANY_CONFIGS = {
    "basic": dict(top_k=5, top_n=10),
    "bm25": dict(top_k=5, top_n=40, use_bm25=True, bm25_top_k=12),
    "bm25_sum": dict(top_k=8, top_n=40, use_bm25=True, bm25_top_k=12,
                     fuse_mode="sum", dense_weight=0.5),
    "ivf": dict(top_k=5, top_n=40, use_ivf=True, use_bm25=True, bm25_top_k=12),
}


def _many_requests(embs, rng, R):
    qs, texts = [], []
    for r in range(R):
        n = 1 + r % 3                              # 1..3 queries per request
        qs.append(np.concatenate([_q_for(embs, r % 2, (3 * r + i) % 12, rng)
                                  for i in range(n)]))
        texts.append([f"chunk{(3 * r + i) % 12} 营业收入" for i in range(n)])
    return qs, texts


@pytest.mark.parametrize("R", [1, 3, 5])
@pytest.mark.parametrize("name", list(MANY_CONFIGS))
def test_search_many_equals_separate_searches_and_jax(ivf_engines, rng, name, R):
    je, te, embs = ivf_engines
    kw = MANY_CONFIGS[name]
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


def test_search_many_over_an_int8_store_with_many_queries(int8_engines, rng):
    """16 requests x 8 padded queries = 128 stacked queries per slot."""
    je, te, embs = int8_engines
    cfg = SearchConfig(top_k=5, top_n=40, use_bm25=True, bm25_top_k=12)
    jc = JaxCfg(top_k=5, top_n=40, use_bm25=True, bm25_top_k=12)
    qs, texts = _many_requests(embs, rng, 16)
    many = te.search_many(qs, "金盘科技", cfg=cfg, query_texts_list=texts)
    jmany = je.search_many(qs, "金盘科技", cfg=jc, query_texts_list=texts)
    for r in (0, 7, 15):
        one = te.search(qs[r], "金盘科技", cfg=cfg, query_texts=texts[r])
        assert_same_results(te.materialize(many[r], cfg), te.materialize(one, cfg))
        assert_same_results(te.materialize(many[r], cfg), je.materialize(jmany[r], jc))


def test_search_many_edge_cases(engines, rng):
    _, te, embs = engines
    assert te.search_many([], "金盘科技") == []
    with pytest.raises(ValueError, match="No report found"):
        te.search_many([_q_for(embs, 0, 0, rng)], "不存在公司")
    with pytest.raises(ValueError, match="build_ivf"):
        te.search_many([_q_for(embs, 0, 0, rng)], "金盘科技",
                       cfg=SearchConfig(use_ivf=True))
    with pytest.raises(ValueError, match="unknown method"):
        te.search_many([_q_for(embs, 0, 0, rng)], "金盘科技",
                       cfg=SearchConfig(method="random_walk"))
