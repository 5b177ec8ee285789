"""BM25: the port's span gather (plain version of kernel K2), scorer and
per-doc top-k against the JAX package.

The span gather is exact.  Scores agree within rtol 1e-5 / atol 1e-4: the
reference sums per-row totals as an f32 cumsum difference in another
order (ops/bm25.py precision note), the port in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.ops import bm25 as jbm
from rag_challenge_2_tpu.ops.pallas_bm25 import gather_posting_spans as jax_gather
from rag_challenge_2_tpu_torch.index.store import load_index
from rag_challenge_2_tpu_torch.ops import bm25 as tbm
from rag_challenge_2_tpu_torch.ops.span_gather import (
    dma_slack, gather_posting_spans, gather_posting_spans_plain)

RTOL, ATOL = 1e-5, 1e-4
QUERIES = ["金盘科技 营业收入", "页面2 chunk7", "doc1 doc1 营业收入 营业收入",
           "", "chunk11 页面4 doc2"]


@pytest.fixture
def both(tiny_corpus, tmp_path):
    """The tiny corpus in the JAX package and, via save/load, in the port."""
    from rag_challenge_2_tpu.index.store import save_index

    idx, meta, *_ = tiny_corpus
    save_index(tmp_path / "idx.npz", idx, meta)
    tidx, _ = load_index(tmp_path / "idx.npz", device="cpu")
    qt = jbm.encode_queries_host(QUERIES, 16, idx.sparse.vocab_bits)
    return idx, tidx, qt


def test_encode_queries_host_matches_jax():
    for bits in (12, 16, 20):
        np.testing.assert_array_equal(
            tbm.encode_queries_host(QUERIES, 16, bits),
            jbm.encode_queries_host(QUERIES, 16, bits))


@pytest.mark.parametrize("with_dl", [False, True])
def test_span_gather_plain_matches_pallas_interpret(both, with_dl):
    idx, tidx, qt = both
    sp, tsp = idx.sparse, tidx.sparse
    W = max(sp.max_postings, 1)
    assert tsp.dma_pad >= dma_slack(W)
    terms = np.maximum(qt, 0).reshape(-1)
    starts = np.asarray(sp.indptr)[terms].astype(np.int32)
    j = jax_gather(sp.chunk_ids, sp.tf, jnp.asarray(starts), window=W,
                   dl=sp.dl if with_dl else None)
    t = gather_posting_spans(tsp.chunk_ids, tsp.tf, torch.from_numpy(starts),
                             window=W, dl=tsp.dl if with_dl else None)
    assert len(t) == len(j) == (3 if with_dl else 2)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_span_gather_plain_clamps_like_the_xla_path(rng):
    """Starts past the end (a CSR without slack) clamp to the last element,
    exactly as the reference's XLA gather does."""
    ids = rng.integers(0, 100, 37).astype(np.int32)
    tf = rng.random(37).astype(np.float32)
    starts = np.array([0, 30, 36, 50], np.int32)
    out = gather_posting_spans_plain(torch.from_numpy(ids), torch.from_numpy(tf),
                                     torch.from_numpy(starts), window=9)
    pos = np.clip(starts[:, None] + np.arange(9), 0, 36)
    np.testing.assert_array_equal(out[0].numpy(), ids[pos])
    np.testing.assert_array_equal(out[1].numpy(), tf[pos])


def test_bm25_scores_match_jax(both):
    idx, tidx, qt = both
    j = np.asarray(jbm.bm25_scores(idx.sparse, jnp.asarray(qt), idx.n_pad, impl="xla"))
    t = tbm.bm25_scores(tidx.sparse, torch.from_numpy(qt), tidx.n_pad).numpy()
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    assert (t[QUERIES.index("")] == 0).all()      # empty query → zeros
    assert (t[0] > 0).sum() > 0


def test_bm25_scores_sum_each_row_in_term_order(both):
    """Each row's score is its terms' contributions added one at a time in
    term order, in f32 (so every device and every run adds alike): equal,
    bitwise, to that sum taken in numpy from the contributions."""
    _, tidx, qt = both
    sp = tidx.sparse
    q = torch.from_numpy(qt)
    rows, contrib = tbm._gather_contributions(
        sp.indptr, sp.chunk_ids, sp.tf, sp.df, sp.chunk_len, sp.avgdl, q,
        window=max(sp.max_postings, 1), k1=1.5, b=0.75, dl=sp.dl)
    want = np.zeros((qt.shape[0], tidx.n_pad), np.float32)
    r, c = rows.numpy(), contrib.numpy()
    for b in range(qt.shape[0]):
        for t in range(qt.shape[1]):
            for w in range(r.shape[2]):
                want[b, r[b, t, w]] = np.float32(want[b, r[b, t, w]] + c[b, t, w])
    got = tbm.bm25_scores(sp, q, tidx.n_pad).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 0


def _routes(idx, docs=(0, 2), M=3):
    doc_id = np.asarray(idx.doc_id)
    valid = np.asarray(idx.valid)
    masks = np.zeros((M, idx.n_pad), bool)
    slot = np.full(idx.n_pad, M, np.int32)
    ws = np.zeros(M, np.int32)
    wl = np.zeros(M, np.int32)
    for i, d in enumerate(docs):
        masks[i] = valid & (doc_id == d)
        slot[masks[i]] = i
        rows = np.flatnonzero(masks[i])
        ws[i], wl[i] = rows[0], len(rows)
    return masks, slot, ws, wl


@pytest.mark.parametrize("mode", ["win_start", "row_slot", "scan"])
@pytest.mark.parametrize("k", [4, 13])
def test_bm25_topk_matches_jax(both, mode, k):
    idx, tidx, qt = both
    masks, slot, ws, wl = _routes(idx)
    kw_j, kw_t = {}, {}
    if mode == "win_start":
        kw_j = dict(win_start=jnp.asarray(ws), win_len=jnp.asarray(wl))
        kw_t = dict(win_start=torch.from_numpy(ws), win_len=torch.from_numpy(wl))
    elif mode == "row_slot":
        kw_j = dict(row_slot=jnp.asarray(slot))
        kw_t = dict(row_slot=torch.from_numpy(slot))
    jv, jr, jok = (np.asarray(a) for a in jbm.bm25_topk(
        idx.sparse, jnp.asarray(qt), jnp.asarray(masks), k, impl="xla", **kw_j))
    tv, tr, tok = (a.numpy() for a in tbm.bm25_topk(
        tidx.sparse, torch.from_numpy(qt), torch.from_numpy(masks), k, **kw_t))
    oracle = tbm.bm25_scores(tidx.sparse, torch.from_numpy(qt), tidx.n_pad).numpy()
    assert tv.shape == jv.shape == (3, len(QUERIES), k)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert (tr[~tok] == -1).all() and (tv[~tok] == 0).all()
    for m in range(3):
        for b in range(len(QUERIES)):
            rows = tr[m, b][tok[m, b]]
            assert len(set(rows.tolist())) == len(rows)
            assert masks[m, rows].all()
            np.testing.assert_allclose(tv[m, b][tok[m, b]], oracle[b, rows],
                                       rtol=RTOL, atol=ATOL)
            # untied rows are the reference's rows; the last kept value
            # is tied if the doc's next-best score (not kept) is close
            v = jv[m, b]
            in_doc = np.sort(oracle[b, masks[m]])[::-1]
            after = in_doc[k] if len(in_doc) > k else -np.inf
            gap = np.minimum(np.abs(np.diff(v, prepend=np.inf)),
                             np.abs(np.diff(v, append=after)))
            sure = jok[m, b] & (gap > 2 * ATOL)
            np.testing.assert_array_equal(tr[m, b][sure], jr[m, b][sure])
    assert not tok[2].any()                   # empty slot
    assert not tok[:, QUERIES.index("")].any()
