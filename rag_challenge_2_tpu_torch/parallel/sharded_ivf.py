"""Multi-device IVF: per-shard clustered indexes + distributed probe merge.

Port of ``rag_challenge_2_tpu/parallel/sharded_ivf.py``.  Each rank owns
a contiguous row range of the corpus and its own IVF over it (k-means per
shard is embarrassingly parallel); a query probes each shard's ``nprobe``
best lists with the port's ``index/ivf.ivf_search`` (kernels K4 and K2 on
the card), and the per-shard top-k candidates merge over the mesh with the
dense merge's lowest-global-row tie rule.  Probing ``nprobe`` lists on
each of S shards scans S·nprobe lists; at ``nprobe = K`` every list is
probed and the result is the exact top-k.

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

from ..device import DeviceLike, resolve_device
from ..index.ivf import IVFIndex, build_ivf, ivf_search, quantize_ivf
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
    shapes = torch.tensor([[ivf.k_clusters, ivf.emb_perm.shape[0], ivf.max_list]],
                          dtype=torch.int64, device=emb.device)
    for a in reversed(axis_names(axis)):          # -> [S, 3], every shard's
        shapes = all_gather_stacked(shapes, mesh.get_group(a)).reshape(-1, 3)
    if bool((shapes[:, 0] != ivf.k_clusters).any()):
        raise ValueError("per-shard IVFs must share k_clusters")
    n_pad, max_list = int(shapes[:, 1].max()), int(shapes[:, 2].max())
    return ShardedIVF(local=_pad_rows(ivf, n_pad, max_list), k_clusters=ivf.k_clusters,
                      max_list=max_list, dim=D, n_shards=S, rows_per_shard=rps,
                      mesh=mesh, axis=axis)


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
    each query to a global contiguous row range, cut to each shard's rows.
    ``mesh`` / ``axis`` default to the ones the index was built over."""
    mesh = mesh if mesh is not None else sivf.mesh
    axis = axis if axis is not None else sivf.axis
    if mesh is None:
        raise ValueError("sharded_ivf_search needs a mesh (build_sharded_ivf "
                         "stamps one; pass mesh= for hand-built indexes)")
    rps = sivf.rows_per_shard
    base = axis_index(mesh, axis) * rps
    kw = {}
    if win_start is not None:
        lo = (win_start - base).clamp(0, rps)
        hi = (win_start + win_len - base).clamp(0, rps)
        kw = dict(win_start=lo.to(torch.int32),
                  win_len=(hi - lo).clamp(min=0).to(torch.int32))
    ivf = sivf.local
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
