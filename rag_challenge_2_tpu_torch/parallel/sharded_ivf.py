"""Multi-device IVF: clustered indexes over a row-sharded store and the
distributed probe merge.

Port of ``rag_challenge_2_tpu/parallel/sharded_ivf.py``.  Each rank owns
a contiguous row range of the corpus and an IVF over its rows; a query
probes ``nprobe`` lists with the port's ``index/ivf.ivf_search`` (kernels
K4 and K2 on the card) on every rank, and the per-shard top-k candidates
merge over the mesh with the dense merge's lowest-global-row tie rule.

Two kinds of ``ShardedIVF``, searched by the one :func:`sharded_ivf_search`:

* **an IVF per shard** (:func:`build_sharded_ivf`, the JAX package's
  form): k-means per shard is embarrassingly parallel, and probing
  ``nprobe`` lists on each of S shards scans S·nprobe lists; at
  ``nprobe = K`` every list is probed and the result is the exact top-k.
* **one IVF over the whole store** (:func:`build_shared_ivf`, or
  :func:`shard_ivf` of a whole-store ``IVFIndex``): the ranks share the
  centroids (k-means over every rank's rows, ``ops/kmeans.kmeans``)
  and the whole store's per-list row bounds, and each rank keeps in every
  list only its own rows.  Every rank probes the lists the whole-store IVF
  would, so the merged top-k is the whole-store ``ivf_search``'s (ties to
  the lowest global row).  This is what the JAX ``QueryEngine(hier=...)
  .build_ivf()`` serves.

Shapes are common to all shards, as in the JAX package: the same
``k_clusters``, ``emb_perm`` padded to the largest shard's row count
(pad rows: zero, row id -1, cluster K, scale 0), and the probe window
``max_list`` is the largest over the shards.  Row ids in a shard's index
are LOCAL; global row = local + shard · ``rows_per_shard``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..index.ivf import (IVFIndex, _balance_clusters, build_ivf, ivf_layout,
                         ivf_search, quantize_ivf, select_probes)
from ..ops.kmeans import kmeans
from ..ops.topk import NEG_INF
from .mesh import Axes, axis_index, axis_names, axis_size
from .sharded_search import all_gather_stacked, merge_over


@dataclasses.dataclass
class ShardedIVF:
    """One rank's shard of a row-sharded IVF: its own ``IVFIndex`` (local
    rows, padded to the common shapes) and the fields common to all shards;
    the candidates merge over ``axis`` of ``mesh``."""

    local: IVFIndex
    k_clusters: int
    max_list: int
    dim: int
    n_shards: int
    rows_per_shard: int
    mesh: object = None
    axis: Axes = "data"
    # one IVF over the whole store (shared centroids): its per-list GLOBAL
    # row bounds, i32 [K] (-1 / -1 for a list no rank holds rows of), from
    # which every rank picks the whole-store probes; None for an IVF per
    # shard
    list_row_min: Optional[torch.Tensor] = None
    list_row_max: Optional[torch.Tensor] = None


def _pad_rows(ivf: IVFIndex, n_pad: int, max_list: int) -> IVFIndex:
    """``ivf`` grown to ``n_pad`` permuted rows (zero rows, row id -1,
    cluster K, scale 0) with the common probe window ``max_list``."""
    pad = n_pad - ivf.emb_perm.shape[0]

    def grow(a, fill):
        if a is None or pad == 0:
            return a
        return torch.cat([a, torch.full((pad, *a.shape[1:]), fill, dtype=a.dtype,
                                        device=a.device)])

    return dataclasses.replace(
        ivf, emb_perm=grow(ivf.emb_perm, 0), row_ids=grow(ivf.row_ids, -1),
        pos_cluster=grow(ivf.pos_cluster, ivf.k_clusters),
        row_scale=grow(ivf.row_scale, 0.0), max_list=max_list)


@torch.inference_mode()
def build_sharded_ivf(
    emb: torch.Tensor,
    mesh,
    n_clusters: int,
    iters: int = 10,
    seed: int = 0,
    valid: Optional[torch.Tensor] = None,
    axis: Axes = "data",
    quantize: bool = False,
) -> ShardedIVF:
    """Build this rank's IVF over its row range of the ``[N, D]`` corpus
    ``emb`` (``seed + shard`` seeds its k-means) and pad it to the shapes
    common to all shards.  Called on every rank: the common ``n_pad`` and
    ``max_list`` come from an all-gather.  ``quantize`` stores int8 rows."""
    S = axis_size(mesh, axis)
    N, D = emb.shape
    if N < S:
        raise ValueError(f"corpus of {N} rows cannot shard {S} ways")
    rps = -(-N // S)
    s = axis_index(mesh, axis)
    lo, hi = s * rps, min(N, (s + 1) * rps)
    ivf = build_ivf(emb[lo:hi], n_clusters=n_clusters, iters=iters, seed=seed + s,
                    valid=None if valid is None else valid[lo:hi])
    if quantize:
        ivf = quantize_ivf(ivf)
    shapes = _cat_ranks(torch.tensor([[ivf.k_clusters, ivf.emb_perm.shape[0],
                                       ivf.max_list]], dtype=torch.int64,
                                     device=emb.device), mesh, axis)   # [S, 3]
    if bool((shapes[:, 0] != ivf.k_clusters).any()):
        raise ValueError("per-shard IVFs must share k_clusters")
    n_pad, max_list = int(shapes[:, 1].max()), int(shapes[:, 2].max())
    return ShardedIVF(local=_pad_rows(ivf, n_pad, max_list), k_clusters=ivf.k_clusters,
                      max_list=max_list, dim=D, n_shards=S, rows_per_shard=rps,
                      mesh=mesh, axis=axis)


def _cat_ranks(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """Every rank's ``[m, ...]`` ``x`` concatenated in the flattened rank
    order of ``axis`` (innermost axis gathered first)."""
    for a in reversed(axis_names(axis)):
        x = all_gather_stacked(x, mesh.get_group(a)).reshape(-1, *x.shape[1:])
    return x


def _all_reduce(x: torch.Tensor, mesh, axis: Axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``axis`` in place (one all-reduce an axis) and
    returned; every rank gets the same values."""
    for a in axis_names(axis):
        dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


def _shared(ivf: IVFIndex, mesh, axis: Axes, rows_per_shard: int) -> ShardedIVF:
    """This rank's part of one IVF over the whole store: ``ivf`` (its rows,
    LOCAL row ids, the shared centroids) padded to the shapes common to all
    ranks, with the whole store's per-list row bounds."""
    S = axis_size(mesh, axis)
    base = axis_index(mesh, axis) * rows_per_shard
    dev = ivf.device
    shapes = _cat_ranks(torch.tensor([[ivf.k_clusters, ivf.emb_perm.shape[0],
                                       ivf.max_list]], dtype=torch.int64, device=dev),
                        mesh, axis)
    if bool((shapes[:, 0] != ivf.k_clusters).any()):
        raise ValueError("the ranks of a shared IVF disagree on k_clusters")
    n_pad, max_list = int(shapes[:, 1].max()), int(shapes[:, 2].max())
    held = ivf.list_row_max >= 0
    lo = torch.where(held, ivf.list_row_min.long() + base,
                     torch.full_like(ivf.list_row_min, 2 ** 31 - 1, dtype=torch.long))
    hi = torch.where(held, ivf.list_row_max.long() + base,
                     torch.full_like(ivf.list_row_max, -1, dtype=torch.long))
    _all_reduce(lo, mesh, axis, dist.ReduceOp.MIN)
    _all_reduce(hi, mesh, axis, dist.ReduceOp.MAX)
    lo = torch.where(hi >= 0, lo, torch.full_like(lo, -1))
    return ShardedIVF(local=_pad_rows(ivf, n_pad, max_list), k_clusters=ivf.k_clusters,
                      max_list=max_list, dim=ivf.dim, n_shards=S,
                      rows_per_shard=rows_per_shard, mesh=mesh, axis=axis,
                      list_row_min=lo.to(torch.int32), list_row_max=hi.to(torch.int32))


@torch.inference_mode()
def build_shared_ivf(
    emb: torch.Tensor,
    mesh,
    n_clusters: Optional[int] = None,
    iters: int = 10,
    seed: int = 0,
    valid: Optional[torch.Tensor] = None,
    axis: Axes = "data",
    quantize: bool = False,
    max_list_size: Optional[int] = None,
) -> ShardedIVF:
    """One IVF over the whole row-sharded store, built on every rank:
    ``emb`` is this rank's ``[rows_per_shard, D]`` f32 / bf16 rows
    (``sharded_search.shard_rows``), ``valid`` its part of the valid column
    (``shard_vec``).  The same arguments on one device give
    ``index.ivf.build_ivf``'s IVF of the whole store: ``n_clusters``
    defaults to 4·sqrt of the GLOBAL valid count, k-means runs over every
    rank's valid rows (:func:`~..ops.kmeans.kmeans` over the ranks: the same
    initial rows, the sums all-reduced), and ``max_list_size`` splits an
    oversized cluster as ``build_ivf`` does, its members gathered from
    their owners onto every rank.  Each rank then lays out its own rows
    of every list; ``quantize`` stores them int8 (``quantize_ivf``, per
    row, so the codes are the whole-store IVF's)."""
    rps, D = emb.shape
    dev = emb.device
    s = axis_index(mesh, axis)
    local = (np.arange(rps) if valid is None
             else np.flatnonzero(valid.cpu().numpy()))
    n = len(local)
    counts = _cat_ranks(torch.tensor([n], dtype=torch.int64, device=dev),
                        mesh, axis).cpu().numpy()
    n_before, n_total = int(counts[:s].sum()), int(counts.sum())
    if n_total == 0:
        raise ValueError("build_shared_ivf: no valid row on any rank")
    K = n_clusters or max(1, int(np.sqrt(n_total) * 4))
    x = emb.float()
    if n != rps:
        x = x[torch.as_tensor(local, device=dev)]

    def all_sum(t):
        return _all_reduce(t, mesh, axis)

    centroids, assign = kmeans(x, K, iters=iters, seed=seed, n_before=n_before,
                               n_total=n_total, all_sum=all_sum)
    assign = assign.cpu().numpy()
    if max_list_size:
        # every rank holds the global assignments (rank order = global
        # valid-row order) and sub-splits the same clusters the same way
        width = int(counts.max())
        every = _cat_ranks(torch.as_tensor(
            np.pad(assign, (0, width - n)), device=dev)[None], mesh, axis).cpu().numpy()
        assign_all = np.concatenate([every[r, :c] for r, c in enumerate(counts)])

        def take(idx):
            own = (idx >= n_before) & (idx < n_before + n)
            out = torch.zeros((*idx.shape, D), dtype=torch.float32, device=dev)
            if own.any():
                out[torch.as_tensor(own, device=dev)] = x[
                    torch.as_tensor(idx[own] - n_before, device=dev)]
            return all_sum(out)

        centroids, assign_all = _balance_clusters(
            x, assign_all, centroids, max_list_size, iters, seed, take=take)
        assign = assign_all[n_before:n_before + n]
    ivf = ivf_layout(x.to(emb.dtype), local, assign, centroids)
    if quantize:
        ivf = quantize_ivf(ivf)
    return _shared(ivf, mesh, axis, rps)


@torch.inference_mode()
def shard_ivf(ivf: IVFIndex, mesh, axis: Axes = "data",
              rows_per_shard: Optional[int] = None) -> ShardedIVF:
    """This rank's part of a whole-store ``IVFIndex`` (every rank passes
    the same one): its rows of every list, in list order, under the
    shared centroids (``rows_per_shard`` defaults to ``shard_rows``'
    split of the IVF's rows).  The merged search equals ``ivf_search`` on
    ``ivf``.  A cluster-ordered IVF (``cluster_doc``) has no row ranges
    to shard."""
    if ivf.cluster_doc is not None or ivf.list_row_min is None:
        raise ValueError("shard_ivf needs an IVF over original rows with list "
                         "bounds, not a cluster-ordered one")
    rid = ivf.row_ids.cpu().numpy()
    if rows_per_shard is None:
        rows_per_shard = -(-(int(rid.max()) + 1) // axis_size(mesh, axis))
    base = axis_index(mesh, axis) * rows_per_shard
    mine = np.flatnonzero((rid >= base) & (rid < base + rows_per_shard))
    at = torch.as_tensor(mine, device=ivf.device)
    local = ivf_layout(
        ivf.emb_perm[at], rid[mine].astype(np.int64) - base,
        ivf.pos_cluster.cpu().numpy()[mine], ivf.centroids,
        row_scale=None if ivf.row_scale is None else ivf.row_scale[at])
    return _shared(local, mesh, axis, rows_per_shard)


def from_jax_sharded_ivf(arrays: Dict, rank: int, mesh, axis: Axes = "data",
                         device: DeviceLike = None) -> ShardedIVF:
    """Shard ``rank`` of a JAX ``ShardedIVF`` carried across as numpy:
    ``arrays`` holds its stacked ``[S, ...]`` fields (``centroids``,
    ``emb_perm``, ``row_ids``, ``pos_cluster``, ``list_offsets``,
    ``list_row_min``, ``list_row_max``, ``row_scale`` or None) and its
    statics (``k_clusters``, ``max_list``, ``dim``, ``n_shards``,
    ``rows_per_shard``).  ``mesh=None`` gives the shard without a mesh
    (for a host replay of one shard)."""
    dev = resolve_device(device)
    if mesh is not None and axis_index(mesh, axis) != rank:
        raise ValueError(f"rank {rank} is not this rank's index over {axis!r}")

    def t(name):
        a = arrays.get(name)
        return None if a is None else torch.as_tensor(np.asarray(a)[rank]).to(dev)

    st = {f: int(arrays[f]) for f in ("k_clusters", "max_list", "dim", "n_shards",
                                      "rows_per_shard")}
    local = IVFIndex(
        centroids=t("centroids"), emb_perm=t("emb_perm"), row_ids=t("row_ids"),
        pos_cluster=t("pos_cluster"), list_offsets=t("list_offsets"),
        row_scale=t("row_scale"), list_row_min=t("list_row_min"),
        list_row_max=t("list_row_max"), k_clusters=st["k_clusters"],
        max_list=st["max_list"], dim=st["dim"])
    return ShardedIVF(local=local, mesh=mesh, axis=axis, **st)


@torch.inference_mode()
def sharded_ivf_search(
    sivf: ShardedIVF,
    q: torch.Tensor,
    k: int,
    mesh=None,
    nprobe: int = 8,
    axis: Optional[Axes] = None,
    win_start: Optional[torch.Tensor] = None,
    win_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k GLOBAL rows per query over every shard's probed lists:
    ``(vals [B, k], rows [B, k])`` on every rank, -1 / NEG_INF where fewer
    than k rows scored.  ``win_start`` / ``win_len`` (``[B]`` i32) route
    each query to a global contiguous row range, cut to each shard's rows
    (with shared centroids, every rank picks the probes from the whole
    store's list bounds and the uncut range: the whole-store IVF's probes).
    ``mesh`` / ``axis`` default to the ones the index was built over."""
    mesh = mesh if mesh is not None else sivf.mesh
    axis = axis if axis is not None else sivf.axis
    if mesh is None:
        raise ValueError("sharded_ivf_search needs a mesh (build_sharded_ivf "
                         "stamps one; pass mesh= for hand-built indexes)")
    rps = sivf.rows_per_shard
    base = axis_index(mesh, axis) * rps
    ivf = sivf.local
    kw = {}
    if win_start is not None:
        lo = (win_start - base).clamp(0, rps)
        hi = (win_start + win_len - base).clamp(0, rps)
        kw = dict(win_start=lo.to(torch.int32),
                  win_len=(hi - lo).clamp(min=0).to(torch.int32))
        if sivf.list_row_min is not None:
            # shared centroids: the whole store's probes on every rank (its
            # list bounds against the uncut windows); the rank's cut window
            # then only masks its candidates
            kw["probes"] = select_probes(
                dataclasses.replace(ivf, list_row_min=sivf.list_row_min,
                                    list_row_max=sivf.list_row_max),
                q, nprobe, win_start=win_start, win_len=win_len)
    # ivf_search returns min(k_l, P·W) columns (P = min(nprobe, K) probes of
    # W = max_list rows each): clamp k_l to that too
    k_l = min(k, ivf.emb_perm.shape[0], min(nprobe, sivf.k_clusters) * sivf.max_list)
    vals, rows = ivf_search(ivf, q, k_l, nprobe=nprobe, window=sivf.max_list, **kw)
    grows = torch.where(rows >= 0, rows + base, torch.full_like(rows, -1))
    mv, mi = merge_over(vals, grows, mesh, axis, k)
    mi = torch.where(mv > NEG_INF / 2, mi, torch.full_like(mi, -1))
    if mv.shape[1] < k:
        # tiny shards (n_pad·S < k): pad to the caller's k columns
        pad = k - mv.shape[1]
        mv = torch.nn.functional.pad(mv, (0, pad), value=NEG_INF)
        mi = torch.nn.functional.pad(mi, (0, pad), value=-1)
    return mv, mi
