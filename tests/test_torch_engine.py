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
    (dict(method="ssg"), "A.10"), (dict(method="triangulation"), "A.10"),
    (dict(method="hybrid_expansion"), "A.10"),
    # IVF is ported: use_ivf without an IVFIndex is refused, as in the
    # reference's engine
    (dict(use_ivf=True), "build_ivf"),
    (dict(scan_rt=0.99), "A.11"),
], ids=["kw0-A.10", "kw1-A.10", "kw2-A.10", "kw3-A.12", "kw4-A.11"])
def test_unported_options_raise(engines, rng, kw, item):
    _, te, embs = engines
    exc = ValueError if kw.get("use_ivf") else NotImplementedError
    with pytest.raises(exc, match=item):
        te.search(_q_for(embs, 0, 0, rng), "金盘科技", cfg=SearchConfig(**kw))


def test_unported_engine_features_raise(engines):
    _, te, _ = engines
    with pytest.raises(NotImplementedError, match="A.9"):
        te.search_many([], "金盘科技")
    with pytest.raises(NotImplementedError, match="A.14"):
        QueryEngine(te.index, te.meta, hier=object())
    # only a single-device IVFIndex is taken; a real one is accepted
    with pytest.raises(NotImplementedError, match="A.14"):
        QueryEngine(te.index, te.meta, ivf=object())
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
