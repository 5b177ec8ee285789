"""The plain reference against the port's CPU versions at a tiny size
(the test may import both; the reference itself imports nothing of the
port)."""

import numpy as np
import pytest
import torch

from benchmark import check, stores
from benchmark.reference import bm25 as rbm25
from benchmark.reference import fusion, routing, scoring
from benchmark.reference.tokenize import term_ids

from .conftest import SEED, tiny

TEXTS = ["2022年金盘科技营业收入是多少？", "2021年金盘科技归属于上市公司股东的净利润是多少？",
         "ＡＢＣ Revenue 12.5% 储能系统", "", "海外市场 overseas 2024", "现金分红 3.14 元"]


@pytest.mark.parametrize("bits", [12, 18, 20])
def test_term_ids_equal_the_port(bits):
    from rag_challenge_2_tpu_torch.ops.bm25 import encode_queries_host

    assert (term_ids(TEXTS, bits) == encode_queries_host(TEXTS, vocab_bits=bits)).all()


@pytest.mark.parametrize("years", [None, [2020, 2021, 2022], [2024, 2025, 2026], [1999], []])
def test_routing_equals_the_engine(years):
    from benchmark import system

    cfg, mix, _ = tiny("flat10m_int8.hybrid_c1")
    store = stores.Store(cfg, SEED, torch.device("cpu"))
    emb = torch.zeros((store.n_rows, store.dim))
    eng = system.build_engine(store, emb, None, store.csr())
    want = eng.routed_docs(cfg["company"], "", years)
    assert routing.routed_docs(store.docs(), cfg["company"], years, 8) == want
    assert routing.routed_docs(store.docs(), cfg["company"], years, 2) == \
        sorted(sorted(want, key=lambda d: (store.docs()[d]["year"], d))[-2:])


def test_int8_scores_equal_the_port_bitwise():
    from rag_challenge_2_tpu_torch.ops.quant import int8_scores, quantize_rows

    g = torch.Generator().manual_seed(3)
    q, x = torch.randn(9, 64, generator=g), torch.randn(500, 64, generator=g)
    codes, scale = quantize_rows(x)
    assert torch.equal(scoring.scores(q, x, "int8"), int8_scores(q, codes, scale))
    assert not torch.equal(scoring.scores(q, x, "int4"), int8_scores(q, codes, scale))
    rc, rs = scoring.quantize(x, 127)
    assert torch.equal(rc, codes.float()) and torch.equal(rs, scale)


def test_bf16_and_f32_scores():
    g = torch.Generator().manual_seed(4)
    q, x = torch.randn(5, 64, generator=g), torch.randn(50, 64, generator=g)
    ref = q.double() @ x.to(torch.bfloat16).double().T
    assert torch.equal(scoring.scores(q, x, "bf16"), ref)
    assert torch.allclose(scoring.scores(q, x, "f32").double(), q.double() @ x.double().T,
                          atol=1e-5)


def test_bm25_row_scores_equal_the_port():
    from rag_challenge_2_tpu_torch.index.schema import SparseIndex
    from rag_challenge_2_tpu_torch.ops.bm25 import bm25_scores

    cfg, _, _ = tiny("flat10m_int8.hybrid_c1")
    store = stores.Store(cfg, SEED, torch.device("cpu"))
    c = store.csr()
    sparse = SparseIndex(indptr=c["indptr"], chunk_ids=c["chunk_ids"], tf=c["tf"],
                         df=c["df"], chunk_len=c["chunk_len"], avgdl=c["avgdl"], dl=c["dl"],
                         vocab_bits=c["vocab_bits"], max_postings=c["W"], dma_pad=c["pad"])
    terms = term_ids(TEXTS, c["vocab_bits"])
    full = bm25_scores(sparse, torch.as_tensor(terms, dtype=torch.int32), store.n_rows)
    csr = check.ref_csr(store)
    for i in range(len(TEXTS)):
        rows, sc = rbm25.row_scores(csr, terms[i])
        want = full[i]
        assert torch.allclose(sc, want[rows], rtol=2e-7, atol=0)
        assert int((want > 0).sum()) == int((sc > 0).sum())


def test_fusion_equals_the_port():
    from rag_challenge_2_tpu_torch.ops.aggregate import fuse_hits

    rng = np.random.default_rng(5)
    L = 400
    key = rng.integers(0, 120, L)
    qid = rng.integers(0, 8, L)
    mid = rng.choice([0, 3], L)
    sim = rng.random(L).astype(np.float32)
    got = fuse_hits(*(torch.as_tensor(a) for a in (key.astype(np.int32), sim,
                                                    qid.astype(np.int32), mid.astype(np.int32),
                                                    key.astype(np.int32))),
                    torch.ones(L, dtype=torch.bool), top_n=30, mode="max")
    hits = [(key[i:i + 1], sim[i:i + 1], np.ones(1, bool), int(qid[i]), int(mid[i]))
            for i in range(L)]
    keys, lo, hi = fusion.fuse_bounds(hits)
    assert np.array_equal(lo, hi)
    top = fusion.top_keys(keys, hi, 30)
    assert np.array_equal(top, got.key.numpy())
    assert np.allclose(hi[np.searchsorted(keys, top)], got.score.numpy(), rtol=1e-6)


def test_tie_ranges_cover_either_choice():
    rows = np.arange(6)
    vals = np.array([5.0, 4.0, 3.0, 3.0, 3.0, 1.0])
    idx, sure = rbm25.top_hits(rows, vals, 3, 0.0)
    assert list(idx) == [0, 1, 2, 3, 4] and list(sure) == [True, True, False, False, False]
    keys, lo, hi = fusion.fuse_bounds([(rows[idx], vals[idx], sure, 0, 0)])
    assert np.isnan(lo[2:]).all() and (hi[2:] == 3.0).all()
