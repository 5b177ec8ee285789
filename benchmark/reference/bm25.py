"""Okapi BM25 over a term-major CSR, and a query's hits in a document.

A posting of term ``t`` in row ``r`` with term frequency ``tf`` adds

    idf(t) * tf * (k1 + 1) / max(tf + k1 * ((1 - b) + b * dl / avgdl), 1e-9)

to the row's score, with ``idf(t) = log1p((n - df + 0.5) / (df + 0.5))``
(the non-negative, Lucene-style idf), ``n`` the rows of non-zero length,
``dl`` the row's length and ``avgdl`` the corpus's mean length as the CSR
gives it.  Each product and quotient is an f32 operation taken in the
order written; a row's score sums its postings' contributions (every
occurrence of a term in the query counts) in f64 and rounds once to f32.
Rows with no positive score are no hits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

K1 = 1.5
B = 0.75


@dataclass
class Csr:
    """The CSR as the benchmark made it: ``indptr [V + 1]`` (host, int64),
    ``chunk_ids`` / ``tf`` over the postings and ``df [V]``,
    ``chunk_len [N]`` on one device, ``avgdl`` the f32 mean length."""
    indptr: np.ndarray
    chunk_ids: torch.Tensor
    tf: torch.Tensor
    df: torch.Tensor
    chunk_len: torch.Tensor
    avgdl: torch.Tensor

    @property
    def n_corpus(self) -> torch.Tensor:
        return torch.clamp((self.chunk_len > 0).sum().to(torch.float32), min=1.0)


def row_scores(csr: Csr, terms: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows [n] int64 ascending, scores [n] f32)`` of one query's term
    ids (``-1`` entries ignored): every row that a term's postings name."""
    dev = csr.chunk_ids.device
    spans = [(int(t), int(csr.indptr[t]), int(csr.indptr[t + 1]))
             for t in terms if t >= 0]
    spans = [(t, s, e) for t, s, e in spans if e > s]
    if not spans:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.float32, device=dev))
    counts = torch.tensor([e - s for _, s, e in spans], device=dev)
    starts = torch.tensor([s for _, s, _ in spans], device=dev)
    term_of = torch.tensor([t for t, _, _ in spans], device=dev).repeat_interleave(counts)
    first = torch.cumsum(counts, 0) - counts
    pos = starts.repeat_interleave(counts) + torch.arange(int(counts.sum()), device=dev) \
        - first.repeat_interleave(counts)
    rows = csr.chunk_ids[pos].long()
    tf = csr.tf[pos].float()
    dl = csr.chunk_len[rows].float()
    df = csr.df[term_of].float()
    idf = torch.log1p((csr.n_corpus - df + 0.5) / (df + 0.5))
    denom = tf + K1 * ((1.0 - B) + B * dl / csr.avgdl)
    contrib = idf * tf * (K1 + 1.0) / torch.clamp(denom, min=1e-9)
    uniq, inv = torch.unique(rows, return_inverse=True)
    total = torch.zeros(uniq.shape[0], dtype=torch.float64, device=dev)
    total.index_add_(0, inv, contrib.double())
    return uniq, total.float()


@dataclass
class Hits:
    """One arm's hits for one (query, document): candidate rows with their
    sims, and whether each is sure (above the k-th best by more than the
    tie tolerance) or only possible (within it of the k-th best)."""
    rows: np.ndarray
    sims: np.ndarray
    sure: np.ndarray


def top_hits(rows: np.ndarray, vals: np.ndarray, k: int, tie: float) -> Tuple[np.ndarray, np.ndarray]:
    """Indices of the candidates among ``vals`` (descending by value) and
    their sure flags: with ``k`` or fewer candidates every one is sure;
    else those within ``tie`` of the k-th value are possible."""
    if vals.size <= k:
        idx = np.arange(vals.size)
        return idx, np.ones(vals.size, bool)
    order = np.lexsort((rows, -vals))
    tau = vals[order[k - 1]]
    idx = np.flatnonzero(vals >= tau - tie)
    return idx, vals[idx] > tau + tie


def bm25_hits(csr: Csr, terms: np.ndarray, doc_ranges: List[Tuple[int, int]],
              k: int, tie: float = 0.0) -> Dict[int, Hits]:
    """One query's BM25 hits in each routed document ``(start, stop)``,
    sims divided by the query's best score over all of them (f32)."""
    rows_t, sc_t = row_scores(csr, terms)
    rows, sc = rows_t.cpu().numpy(), sc_t.cpu().numpy()
    keep = sc > 0
    rows, sc = rows[keep], sc[keep]
    in_doc = [(rows >= s) & (rows < e) for s, e in doc_ranges]
    routed = np.any(in_doc, axis=0) if in_doc else np.zeros(rows.shape, bool)
    best = np.float32(max(float(sc[routed].max()) if routed.any() else 0.0, 1e-9))
    out = {}
    for m, sel in enumerate(in_doc):
        r, v = rows[sel], sc[sel]
        idx, sure = top_hits(r, v, k, tie)
        out[m] = Hits(r[idx], (v[idx] / best).astype(np.float32), sure)
    return out
