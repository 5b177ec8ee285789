"""Batched BM25 scoring over the corpus-wide CSR term index.

Port of ``rag_challenge_2_tpu/ops/bm25.py``.  Queries arrive as padded
``[B, T]`` term-id batches; each term's postings are one contiguous CSR
span, copied by kernel K2 (:mod:`.span_gather`) on the card.  Two back
halves:

* :func:`bm25_topk` (the serving path) — sort by row, per-row totals,
  then the per-doc top-k through one (slot, score) sort, or a per-doc
  scan when no slot map is given; memory scales with B·T·window, never
  with the corpus.
* :func:`bm25_scores` — the full ``[B, N]`` score matrix by scatter-add;
  the oracle for tests and small corpora.

:class:`HostBM25Scorer` is the same ``[B, N]`` matrix in numpy, for the
pretraining sampler's teacher on small corpora (``models/pretrain.py``).

Scoring model: Okapi BM25 with the non-negative (Lucene-style) idf
``log(1 + (N - df + 0.5)/(df + 0.5))``, the reference's formula operation
for operation.

Per-row totals come from a float64 cumulative sum of the f32
contributions, rounded once to f32.  The reference takes an f32 cumsum;
f64 keeps the totals of mathematically equal rows equal on every device
(the card's scan and the CPU's add in different orders), so tie order
does not depend on where the engine runs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..index.schema import SparseIndex
from .span_gather import gather_posting_spans
from .topk import NEG_INF


def _gather_contributions(
    indptr, chunk_ids, tf, df, chunk_len, avgdl, query_terms, *,
    window: int, k1: float, b: float, dl=None,
):
    """Per-(term, posting) BM25 contributions: ``(rows, contrib)`` of shape
    ``[B, T, W]``.  The span copy goes through K2 on a CUDA tensor."""
    B, T = query_terms.shape
    terms = query_terms.clamp(min=0).long()
    starts = indptr[terms]                                   # [B, T]
    counts = indptr[terms + 1] - starts
    counts = torch.where(query_terms >= 0, counts, torch.zeros_like(counts))
    offs = torch.arange(window, dtype=torch.int32, device=query_terms.device)
    in_window = offs[None, None, :] < counts[..., None]

    out = gather_posting_spans(
        chunk_ids, tf, starts.reshape(-1).to(torch.int32).contiguous(),
        window=window, dl=dl,
    )
    rows = out[0].reshape(B, T, window)
    tfv = out[1].reshape(B, T, window)
    dlv = out[2].reshape(B, T, window) if dl is not None else None

    n_corpus = torch.clamp((chunk_len > 0).sum().to(torch.float32), min=1.0)
    dfv = df[terms]
    idf = torch.log1p((n_corpus - dfv + 0.5) / (dfv + 0.5))
    idf = torch.where(query_terms >= 0, idf, torch.zeros_like(idf))

    if dlv is None:
        dlv = chunk_len[rows.long()]
    denom = tfv + k1 * (1.0 - b + b * dlv / avgdl)
    contrib = idf[..., None] * tfv * (k1 + 1.0) / torch.clamp(denom, min=1e-9)
    contrib = torch.where(in_window, contrib, torch.zeros_like(contrib))
    return rows, contrib


def _window(sparse: SparseIndex, window: Optional[int]) -> int:
    return int(window or max(sparse.max_postings, 1))


def bm25_scores(
    sparse: SparseIndex,
    query_terms: torch.Tensor,
    n_rows: int,
    *,
    k1: float = 1.5,
    b: float = 0.75,
    window: Optional[int] = None,
) -> torch.Tensor:
    """``[B, n_rows]`` f32 BM25 scores (0 where no term matches) for
    ``[B, T]`` hashed term ids padded with -1.  ``window`` defaults to the
    longest posting list (exact).

    A row sums its terms' contributions in term order, on every device and
    every run: one scatter a term.  A term's postings name a row once (the
    window's tail past them adds zeros), so no two adds of one scatter
    meet; a single scatter of every term adds by atomics on the card, in
    an order that changes from run to run, and near-tied rows then trade
    places."""
    W = _window(sparse, window)
    rows, contrib = _gather_contributions(
        sparse.indptr, sparse.chunk_ids, sparse.tf, sparse.df,
        sparse.chunk_len, sparse.avgdl, query_terms,
        window=W, k1=k1, b=b, dl=sparse.dl,
    )
    B, T = query_terms.shape
    scores = torch.zeros((B, n_rows), dtype=torch.float32,
                         device=query_terms.device)
    rows = rows.long()
    for t in range(T):
        scores.scatter_add_(1, rows[:, t], contrib[:, t])
    return scores


def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1, stable=True)[1]


def bm25_topk(
    sparse: SparseIndex,
    query_terms: torch.Tensor,
    doc_masks: torch.Tensor,
    k: int,
    *,
    row_slot: Optional[torch.Tensor] = None,
    win_start: Optional[torch.Tensor] = None,
    win_len: Optional[torch.Tensor] = None,
    k1: float = 1.5,
    b: float = 0.75,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-document BM25 top-k without materializing ``[B, N]`` scores.

    CONTRACT for ``row_slot`` / ``win_start``+``win_len`` (the reference's):
    ``doc_masks[m]`` must equal ``row_slot == m`` (or the row range of
    slot m) exactly.  Without either, each doc mask is scanned.

    Args:
        query_terms: ``[B, T]`` hashed term ids, -1 padded.
        doc_masks: ``[M, N_pad]`` bool routed row masks (disjoint).
        k: per-(query, doc) candidates.
        row_slot: optional ``[N_pad]`` i32 slot per row (M = unrouted).
        win_start / win_len: optional ``[M]`` i32 contiguous row range of
            each slot; takes precedence over ``row_slot``.

    Returns ``(scores [M, B, k] f32 — 0 where invalid, rows [M, B, k] i32
    — -1 where invalid, valid [M, B, k] bool)``.
    """
    W = _window(sparse, window)
    B = query_terms.shape[0]
    rows, contrib = _gather_contributions(
        sparse.indptr, sparse.chunk_ids, sparse.tf, sparse.df,
        sparse.chunk_len, sparse.avgdl, query_terms,
        window=W, k1=k1, b=b, dl=sparse.dl,
    )
    r_flat = rows.reshape(B, -1)
    c_flat = contrib.reshape(B, -1)
    L = r_flat.shape[1]
    dev = r_flat.device

    # sort postings by row; per-row totals sit at each segment's last
    # position (contributions are non-negative, so the running sum is
    # monotone and a forward cummax carries each segment's base)
    r_s, order = torch.sort(r_flat, dim=1, stable=True)
    c_s = torch.gather(c_flat, 1, order).double()
    cs = torch.cumsum(c_s, dim=1)
    change = r_s[:, 1:] != r_s[:, :-1]
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    first = torch.cat([ones, change], dim=1)
    last = torch.cat([change, ones], dim=1)
    base = torch.cummax(
        torch.where(first, cs - c_s, torch.zeros_like(cs)), dim=1)[0]
    totals = (cs - base).float()
    neg_inf = torch.full_like(totals, NEG_INF)
    scores = torch.where(last & (totals > 0.0), totals, neg_inf)   # [B, L]

    M = doc_masks.shape[0]
    safe = r_s.long().clamp(0, doc_masks.shape[1] - 1)

    if row_slot is not None or win_start is not None:
        if win_start is not None:
            # contiguous-range corpora: the slot is arithmetic in the row
            rr = r_s[:, :, None]
            in_m = (rr >= win_start[None, None, :]) & (
                rr < (win_start + win_len)[None, None, :])
            slot_of_row = torch.where(
                in_m.any(-1), torch.argmax(in_m.to(torch.uint8), -1),
                torch.full_like(safe, M))
        else:
            slot_of_row = row_slot[safe].long()
        slot = torch.where(scores > NEG_INF / 2, slot_of_row,
                           torch.full_like(slot_of_row, M))
        # one stable sort by (slot, -score): minor key first, then major
        o1 = _stable_argsort(-scores)
        o2 = _stable_argsort(torch.gather(slot, 1, o1))
        perm = torch.gather(o1, 1, o2)
        sl = torch.gather(slot, 1, perm)
        vals = torch.gather(scores, 1, perm)
        rr_s = torch.gather(r_s, 1, perm)
        pos = torch.arange(L, device=dev).expand(B, L)
        new_slot = torch.cat([ones, sl[:, 1:] != sl[:, :-1]], dim=1)
        seg_start = torch.cummax(
            torch.where(new_slot, pos, torch.zeros_like(pos)), dim=1)[0]
        rank = pos - seg_start
        keep = (sl < M) & (rank < k)
        p = torch.where(keep, sl * k + rank, torch.full_like(sl, M * k))
        out_v = torch.zeros((B, M * k + 1), dtype=torch.float32, device=dev)
        out_r = torch.full((B, M * k + 1), -1, dtype=torch.int32, device=dev)
        # kept positions are unique; only the discarded last column
        # receives duplicate writes
        out_v.scatter_(1, p, vals)
        out_r.scatter_(1, p, rr_s.to(torch.int32))
        bv = out_v[:, : M * k].reshape(B, M, k).transpose(0, 1)
        br = out_r[:, : M * k].reshape(B, M, k).transpose(0, 1)
        valid = br >= 0
        return torch.where(valid, bv, torch.zeros_like(bv)), br, valid

    bvs, brs = [], []
    for m in range(M):
        in_doc = doc_masks[m][safe]
        sv = torch.where(in_doc, scores, neg_inf)
        v, j = torch.sort(sv, dim=1, descending=True, stable=True)
        v, j = v[:, :k], j[:, :k]
        if v.shape[1] < k:
            pad = k - v.shape[1]
            v = torch.nn.functional.pad(v, (0, pad), value=NEG_INF)
            j = torch.nn.functional.pad(j, (0, pad), value=0)
        bvs.append(v)
        brs.append(torch.gather(r_s, 1, j))
    bv = torch.stack(bvs)
    br = torch.stack(brs).to(torch.int32)
    valid = bv > NEG_INF / 2
    return (torch.where(valid, bv, torch.zeros_like(bv)),
            torch.where(valid, br, torch.full_like(br, -1)), valid)


def encode_queries_host(texts, max_terms: int = 64, vocab_bits: int = 20):
    """Host-side: tokenize + hash query texts into a padded ``[B, T]``
    numpy id batch (the C++ tokenizer when available — byte-identical
    ids — else the pure-Python path)."""
    from ..utils.native import tokenize_queries_native

    texts = list(texts)
    out = tokenize_queries_native(texts, vocab_bits, max_terms)
    if out is None:
        from ..utils import tokenize as tok

        out = np.full((len(texts), max_terms), -1, np.int32)
        for i, t in enumerate(texts):
            ids = tok.token_ids(t, vocab_bits)[:max_terms]
            out[i, : len(ids)] = ids
    return np.asarray(out)


def encode_queries(texts, max_terms: int = 64, vocab_bits: int = 20,
                   device: DeviceLike = None) -> torch.Tensor:
    """:func:`encode_queries_host` put on ``device`` (the card unless the
    caller names another)."""
    return torch.from_numpy(encode_queries_host(texts, max_terms, vocab_bits)).to(
        resolve_device(device))


class HostBM25Scorer:
    """Host (numpy) mirror of :func:`bm25_scores` for SMALL corpora.

    The pretraining teacher (``models/pretrain.PairSampler``) needs a
    ``[B, N]`` score matrix back on the host every step to pick neighbour
    passages; the sampler scores locally and the device runs only the
    train step.

    Same formula and f32 arithmetic as :func:`_gather_contributions`
    (Lucene idf, k1 / b saturation, per-posting doc length) over the full
    posting lists, which equals :func:`bm25_scores`' default window;
    scores agree to f32 rounding.  The CSR is read from ``sparse`` on any
    device.

    A posting's contribution ``idf(term) * tf * (k1 + 1) / max(tf + k1 *
    (1 - b + b * dl / avgdl), 1e-9)`` depends on nothing but the posting,
    so it is computed once for every posting of the corpus (per ``(k1,
    b)``, on first use) with the reference's f32 operations in its order;
    a call then copies each query term's span of contributions and row ids
    and sums them per (query, row) in float64 in the reference's order.
    The scores equal the JAX package's ``HostBM25Scorer`` bitwise.
    """

    def __init__(self, sparse: SparseIndex):
        def host(t):
            return t.detach().cpu().numpy()

        self.indptr = host(sparse.indptr).astype(np.int64)
        self.chunk_ids = host(sparse.chunk_ids)
        self.tf = np.asarray(host(sparse.tf), np.float32)
        self.df = np.asarray(host(sparse.df), np.float32)
        self.chunk_len = np.asarray(host(sparse.chunk_len), np.float32)
        self.avgdl = float(host(sparse.avgdl).reshape(-1)[0])
        self.n_corpus = max(float((self.chunk_len > 0).sum()), 1.0)
        self._contrib: Dict[Tuple[float, float], np.ndarray] = {}

    def _contributions(self, k1: float, b: float) -> np.ndarray:
        """Every posting's f32 contribution, in CSR order."""
        got = self._contrib.get((k1, b))
        if got is None:
            nnz = int(self.indptr[-1])
            term = np.repeat(np.arange(len(self.df)), np.diff(self.indptr))
            tfv = self.tf[:nnz]
            one_minus = np.float32(k1 * (1.0 - b))
            b_over = np.float32(k1 * b / self.avgdl)
            denom = tfv + (one_minus + b_over
                           * self.chunk_len[self.chunk_ids[:nnz].astype(np.int64)])
            dfv = self.df[term]
            idf = np.log1p((np.float32(self.n_corpus) - dfv + np.float32(0.5))
                           / (dfv + np.float32(0.5))).astype(np.float32)
            got = (idf * tfv * np.float32(k1 + 1.0)
                   / np.maximum(denom, np.float32(1e-9)))
            self._contrib[(k1, b)] = got
        return got

    def scores(self, query_ids, n_rows: int, k1: float = 1.5,
               b: float = 0.75) -> np.ndarray:
        """``[B, n_rows]`` f32 scores; ``query_ids`` ``[B, T]`` numpy, -1
        padded."""
        B, T = query_ids.shape
        q = query_ids.astype(np.int64)
        valid = q >= 0
        terms = np.where(valid, q, 0)
        starts = self.indptr[terms]                     # [B, T]
        counts = np.where(valid, self.indptr[terms + 1] - starts, 0).reshape(-1)
        if int(counts.sum()) == 0:
            return np.zeros((B, n_rows), np.float32)
        contrib = self._contributions(k1, b)
        spans = [slice(s, s + c) for s, c in
                 zip(starts.reshape(-1).tolist(), counts.tolist()) if c]
        rows = np.concatenate([self.chunk_ids[x] for x in spans])
        weights = np.concatenate([contrib[x] for x in spans])
        # flat (query, row) bins in (query, term, posting) order: bincount
        # adds each bin's contributions in that order, as the reference
        bins = np.repeat((np.arange(B * T) // T) * n_rows, counts) + rows
        out = np.bincount(bins, weights=weights, minlength=B * n_rows)
        return out.reshape(B, n_rows).astype(np.float32)
