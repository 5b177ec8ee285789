"""Multi-device sparse (BM25) search: row-range CSR shards + merged top-k.

Port of ``rag_challenge_2_tpu/parallel/sharded_sparse.py``.
:func:`shard_sparse_index` partitions the corpus CSR by chunk row range on
the host, exactly as the JAX function does (the same shards, the same
1024-rounded length ``L``, the same ``max_postings``, term-major order
within each shard), so every row's postings land on one shard and
per-shard scores are complete row totals.  :func:`sharded_bm25_topk` runs
the single-device ``ops/bm25.bm25_topk`` (kernel K2 in front on the card)
on each held shard and merges the per-shard top-k with the lowest-row tie
rule of the dense merge (``sharded_search.select_lowest_rows``).

Two placements, as in the JAX package:

* ``mesh=None``: all S shards stacked in this process, searched one after
  the other (the JAX function ``vmap``s them on one device);
* with a mesh: this rank holds its own shard (its index over ``axis``)
  and the candidates merge over the mesh by an all-gather; every rank
  returns the merged result.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..index.schema import ShardedSparseIndex, SparseIndex
from ..ops.bm25 import bm25_topk
from ..ops.topk import NEG_INF
from .mesh import Axes, axis_index, axis_size
from .sharded_search import merge_over, select_lowest_rows


def _partition(sparse: SparseIndex, n_shards: int) -> Dict[str, np.ndarray]:
    """The JAX package's host partition, array for array: shard s owns rows
    ``[s·rows_per, (s+1)·rows_per)`` and every posting whose chunk id lies
    there (the boolean selection keeps term-major order)."""
    def host(t):
        return t.detach().cpu().numpy()

    indptr = host(sparse.indptr).astype(np.int64)
    nnz = int(indptr[-1])
    ids = host(sparse.chunk_ids)[:nnz]
    tfv = host(sparse.tf)[:nnz]
    V = indptr.shape[0] - 1
    n_pad = sparse.chunk_len.shape[0]
    rows_per = -(-n_pad // n_shards)
    term_of = np.repeat(np.arange(V, dtype=np.int64), np.diff(indptr))
    shard_of = np.minimum(ids // rows_per, n_shards - 1)

    parts = []
    L = 1
    max_post = 0
    for s in range(n_shards):
        sel = shard_of == s
        cnt = np.bincount(term_of[sel], minlength=V)
        ip = np.zeros(V + 1, np.int64)
        np.cumsum(cnt, out=ip[1:])
        parts.append((ip, ids[sel], tfv[sel]))
        L = max(L, int(sel.sum()))
        if V:
            max_post = max(max_post, int(cnt.max()))
    L = -(-L // 1024) * 1024
    sip = np.zeros((n_shards, V + 1), np.int32)
    sid = np.zeros((n_shards, L), np.int32)
    stf = np.zeros((n_shards, L), np.float32)
    sdl = np.zeros((n_shards, L), np.float32)
    clen = host(sparse.chunk_len)
    for s, (ip, i_s, t_s) in enumerate(parts):
        sip[s] = ip
        sid[s, : len(i_s)] = i_s
        stf[s, : len(t_s)] = t_s
        sdl[s, : len(i_s)] = clen[i_s]
    return dict(indptr=sip, chunk_ids=sid, tf=stf, dl=sdl, max_postings=max_post)


def shard_sparse_index(sparse: SparseIndex, n_shards: int, mesh=None,
                       axis: Axes = "data") -> ShardedSparseIndex:
    """Partition a corpus CSR into per-row-range shards (a host build; the
    arrays land on the device of ``sparse``).  Without ``mesh`` all shards
    are kept, stacked; with one, ``n_shards`` must be the shard count over
    ``axis`` and this rank keeps only its own shard."""
    p = _partition(sparse, n_shards)
    dev = sparse.indptr.device
    stacked = ShardedSparseIndex(
        indptr=torch.from_numpy(p["indptr"]).to(dev),
        chunk_ids=torch.from_numpy(p["chunk_ids"]).to(dev),
        tf=torch.from_numpy(p["tf"]).to(dev),
        df=sparse.df, chunk_len=sparse.chunk_len, avgdl=sparse.avgdl,
        dl=torch.from_numpy(p["dl"]).to(dev),
        vocab_bits=sparse.vocab_bits, max_postings=p["max_postings"],
        n_shards=n_shards)
    return stacked if mesh is None else take_shard(stacked, mesh, axis)


def take_shard(stacked: ShardedSparseIndex, mesh, axis: Axes = "data"
               ) -> ShardedSparseIndex:
    """This rank's one-shard form of a stacked index: the shard at its
    index over ``axis``, bound to ``mesh`` for the merge."""
    if stacked.mesh is not None or stacked.indptr.shape[0] != stacked.n_shards:
        raise ValueError("take_shard takes the stacked form (all shards, no mesh)")
    S = axis_size(mesh, axis)
    if S != stacked.n_shards:
        raise ValueError(f"{stacked.n_shards} shards over a mesh axis of {S} ranks")
    s = axis_index(mesh, axis)
    one = slice(s, s + 1)
    return ShardedSparseIndex(
        indptr=stacked.indptr[one], chunk_ids=stacked.chunk_ids[one],
        tf=stacked.tf[one], df=stacked.df, chunk_len=stacked.chunk_len,
        avgdl=stacked.avgdl,
        dl=None if stacked.dl is None else stacked.dl[one],
        vocab_bits=stacked.vocab_bits, max_postings=stacked.max_postings,
        n_shards=stacked.n_shards, mesh=mesh, axis=axis)


def from_jax_sharded_sparse(arrays: Dict, rank: Optional[int] = None, mesh=None,
                            axis: Axes = "data", device: DeviceLike = None
                            ) -> ShardedSparseIndex:
    """A JAX ``ShardedSparseIndex`` carried across as numpy: ``arrays``
    holds its stacked ``[S, ...]`` fields (``indptr``, ``chunk_ids``,
    ``tf``, ``dl``) and ``df``, ``chunk_len``, ``avgdl``, ``vocab_bits``,
    ``max_postings``, ``n_shards``.  ``rank=None`` keeps all shards
    (stacked); else ``mesh`` is required and ``rank`` must be this rank's
    index over ``axis``."""
    dev = resolve_device(device)

    def t(name):
        return torch.as_tensor(np.asarray(arrays[name])).to(dev)

    stacked = ShardedSparseIndex(
        indptr=t("indptr"), chunk_ids=t("chunk_ids"), tf=t("tf"), df=t("df"),
        chunk_len=t("chunk_len"), avgdl=t("avgdl"),
        dl=t("dl") if arrays.get("dl") is not None else None,
        vocab_bits=int(arrays["vocab_bits"]),
        max_postings=int(arrays["max_postings"]), n_shards=int(arrays["n_shards"]))
    if rank is None:
        return stacked
    if mesh is None or axis_index(mesh, axis) != rank:
        raise ValueError("a rank's shard needs the mesh it sits at, at that rank")
    return take_shard(stacked, mesh, axis)


def sharded_bm25_topk(
    sparse: ShardedSparseIndex,
    query_terms: torch.Tensor,
    doc_masks: torch.Tensor,
    k: int,
    *,
    row_slot: Optional[torch.Tensor] = None,
    k1: float = 1.5,
    b: float = 0.75,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-document BM25 top-k over the sharded CSR.

    The contract of ``ops.bm25.bm25_topk`` (``(scores [M, B, k], rows
    [M, B, k], valid [M, B, k])``, global corpus rows, the ``row_slot``
    disjoint-mask requirement per shard); ties go to the lowest global
    row, as on one device.  With a mesh, called on every rank."""
    W = int(window or max(sparse.max_postings, 1))
    vals, rows = [], []
    for s in range(sparse.indptr.shape[0]):
        shard = SparseIndex(
            indptr=sparse.indptr[s], chunk_ids=sparse.chunk_ids[s], tf=sparse.tf[s],
            df=sparse.df, chunk_len=sparse.chunk_len, avgdl=sparse.avgdl,
            dl=None if sparse.dl is None else sparse.dl[s],
            vocab_bits=sparse.vocab_bits, max_postings=sparse.max_postings)
        v, r, ok = bm25_topk(shard, query_terms, doc_masks, k, row_slot=row_slot,
                             k1=k1, b=b, window=W)
        vals.append(torch.where(ok, v, torch.full_like(v, NEG_INF)))
        rows.append(r)
    v = torch.stack(vals, dim=2).flatten(2)             # [M, B, S_held * k]
    r = torch.stack(rows, dim=2).flatten(2)
    mv, mr = select_lowest_rows(v, r, k)
    if sparse.mesh is not None:
        mv, mr = merge_over(mv, mr, sparse.mesh, sparse.axis, k)
    valid = mv > NEG_INF / 2
    return (torch.where(valid, mv, torch.zeros_like(mv)),
            torch.where(valid, mr, torch.full_like(mr, -1)), valid)
