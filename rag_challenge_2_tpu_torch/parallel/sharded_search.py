"""Multi-device exact search: row-sharded embeddings + distributed top-k.

Port of ``rag_challenge_2_tpu/parallel/sharded_search.py``.  The JAX
module writes each search as a ``shard_map`` body, a per-device program
with named-axis collectives; here that body is the rank program itself
(``parallel/launch.py`` starts the ranks, ``parallel/mesh.py`` names their
axes).  Every rank holds only its rows of the store and scores them with
the port's own kernels (``ops/topk.dense_topk``: K1 for f32 / bf16 stores
up to 64 queries, K3 for int8 stores or more queries, ``wide_topk`` above
k = 64); the JAX body's ``jnp.dot(HIGHEST)`` + ``lax.top_k`` is the same
function.  The per-rank candidates then merge over the mesh by an
all-gather, ties to the LOWEST GLOBAL ROW at every level (gather
(value, row), order by row, select stably), so the merged result equals
the single-device top-k.

Placement: ``P(axis, None)`` becomes "rank r holds rows
``[r·rows_per_shard, (r+1)·rows_per_shard)``" (:func:`shard_rows`, pad rows
zero, masked out, scale 0); ``P()`` is a tensor every rank holds; the
replicated result is the merged ``(vals, rows)`` every rank returns.

Every function here is called on every rank of the mesh, in the same
order: the collectives pair up by call.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.topk import NEG_INF, dense_topk, stable_topk
from .mesh import Axes, axis_index, axis_names, axis_size

_NO_ROW = 2 ** 30        # sort key of a row-less (-1) candidate: after every row


def all_gather_stacked(x: torch.Tensor, group) -> torch.Tensor:
    """``[S, *x.shape]``: every rank's ``x`` over ``group``, in rank order,
    on ``x``'s device.  NCCL gathers on the cards; gloo takes CUDA tensors
    too and stages them through host memory itself (checked on an H100
    with torch 2.11)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def merge_candidates(vals: torch.Tensor, rows: torch.Tensor, group, k: int,
                     payload: Sequence[torch.Tensor] = ()) -> Tuple[torch.Tensor, ...]:
    """All-gather ``[..., k_in]`` candidates (global rows, -1 = none) over
    ``group`` and keep the top ``min(k, S·k_in)`` per leading index: order
    by row, then a stable descending selection, so equal values go to the
    lower global row and row-less candidates come last.

    ``payload``: f32 columns of ``vals``' shape that travel with their
    candidates (one all-gather beside the values').  Returns ``(vals,
    rows)``, then the selected payload columns in order."""
    lead = vals.shape[:-1]
    af = all_gather_stacked(torch.stack([vals, *payload]), group)   # [S, 1+P, ..., k_in]
    ai = all_gather_stacked(rows, group)                            # [S, ..., k_in]
    cols = [af[:, j].movedim(0, -2).reshape(*lead, -1) for j in range(af.shape[1])]
    return select_lowest_rows(cols[0], ai.movedim(0, -2).reshape(*lead, -1), k,
                              cols[1:])


def select_lowest_rows(vals: torch.Tensor, rows: torch.Tensor, k: int,
                       payload: Sequence[torch.Tensor] = ()) -> Tuple[torch.Tensor, ...]:
    """The top ``min(k, n)`` of ``[..., n]`` candidates (global rows, -1 =
    none), equal values to the lower row: order by row, then a stable
    descending selection (never ``torch.topk``, which has no tie order).
    ``payload`` columns (``vals``' shape) are gathered by the same indices
    and returned after ``(vals, rows)``."""
    key = torch.where(rows >= 0, rows.long(),
                      torch.full_like(rows, _NO_ROW, dtype=torch.long))
    order = torch.sort(key, dim=-1, stable=True)[1]
    vals = torch.gather(vals, -1, order)
    rows = torch.gather(rows, -1, order)
    mv, midx = stable_topk(vals, min(k, vals.shape[-1]))
    return (mv, torch.gather(rows, -1, midx),
            *(torch.gather(torch.gather(p, -1, order), -1, midx) for p in payload))


def merge_over(vals: torch.Tensor, rows: torch.Tensor, mesh: DeviceMesh,
               axis: Axes, k: int, payload: Sequence[torch.Tensor] = ()
               ) -> Tuple[torch.Tensor, ...]:
    """:func:`merge_candidates` over one mesh axis, or over several from
    the innermost out (the two-level merge: each outer level ships k
    candidates a group, and the tie rule makes it equal the flat merge).
    ``payload`` columns travel with their candidates at every level."""
    payload = tuple(payload)
    for a in reversed(axis_names(axis)):
        vals, rows, *payload = merge_candidates(vals, rows, mesh.get_group(a), k,
                                                payload)
    return (vals, rows, *payload)


def _shard_of(x: torch.Tensor, mesh: DeviceMesh, axis: Axes, fill) -> torch.Tensor:
    S = axis_size(mesh, axis)
    n = x.shape[0]
    per = -(-n // S)
    lo = axis_index(mesh, axis) * per
    part = x[lo: lo + per]
    if part.shape[0] == per:
        return part
    pad = torch.full((per - part.shape[0], *x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([part, pad])


def shard_rows(emb: torch.Tensor, mesh: DeviceMesh, axis: Axes = "data") -> torch.Tensor:
    """This rank's rows of ``[N, D]`` placed ``P(axis, None)``: rows
    ``[r·per, (r+1)·per)`` with ``per = ceil(N / S)``, the last shard padded
    with zero rows as the JAX wrappers pad (a view when no padding is
    needed)."""
    return _shard_of(emb, mesh, axis, 0)


def shard_vec(x: torch.Tensor, mesh: DeviceMesh, axis: Axes = "data", fill=0) -> torch.Tensor:
    """This rank's part of an ``[N]`` row vector, placed as
    :func:`shard_rows` places the rows; pad entries take ``fill`` (False
    for a mask, 0 for a row scale)."""
    return _shard_of(x, mesh, axis, fill)


def _local_topk(q, emb_l, k_l, mask_l, scale_l, base):
    """One rank's top-``k_l`` with GLOBAL rows (-1 where nothing scored)."""
    vals, idx = dense_topk(q, emb_l, k_l, mask=mask_l, row_scale=scale_l)
    rows = torch.where(vals > NEG_INF / 2, idx + base, torch.full_like(idx, -1))
    return vals, rows


def make_sharded_topk(mesh: DeviceMesh, k: int, axis: Axes = "data",
                      int8: bool = False) -> Callable:
    """The distributed top-k: ``(q, emb_local, mask_local[, scale_local])
    → (vals [B, k'], rows [B, k'])``, the same on every rank.

    ``q`` ``[B, D]`` is replicated; ``emb_local`` ``[rows_per_shard, D]`` is
    this rank's rows (:func:`shard_rows`), ``mask_local`` its ``[rows]``
    mask, ``scale_local`` its int8 row scales (``int8=True``).  Each rank
    keeps ``min(k, rows_per_shard)`` candidates (a shard with fewer eligible
    rows returns NEG_INF / row -1 for the rest), and ``k' = min(k, S·k_l)``.
    Rows are global indices into the padded store."""

    def run(q, emb_l, mask_l, *rest):
        if int8 != bool(rest):
            raise ValueError("int8=True takes the local row scales, and only then")
        rps = emb_l.shape[0]
        k_l = min(k, rps)
        vals, rows = _local_topk(q, emb_l, k_l, mask_l, rest[0] if int8 else None,
                                 axis_index(mesh, axis) * rps)
        return merge_over(vals, rows, mesh, axis, k)

    return run


def make_hierarchical_topk(mesh: DeviceMesh, k: int, slice_axis: str = "slice",
                           dev_axis: str = "device", int8: bool = False,
                           pair_mask: bool = False) -> Callable:
    """Two-level distributed top-k over a (slice × device) mesh.

    Rows shard over the flattened (slice, device) order, global row =
    ``((slice · n_dev) + dev) · rows_per_shard + local row``.  Each rank's
    candidates merge first within its slice (the ``dev_axis`` group), then
    across slices (the ``slice_axis`` group), where each slice ships exactly
    k candidates.  Ties go to the lower global row at both levels, so the
    result equals :func:`make_sharded_topk` over the flat mesh and the
    single-device kernel.

    Without ``pair_mask`` the call is :func:`make_sharded_topk`'s.  With
    ``pair_mask=True`` it is the engine's (query × doc slot) grid:
    ``(q [Q, D], emb_local, doc_masks_local [M, rows], q_valid [Q],
    doc_valid [M] host bool[, scale_local], win_start=None, win_len=None)
    → [Q·M, k']`` with pair p = q·M + m.  The JAX body takes a per-pair
    ``[Q·M, N]`` mask; the kernels take a row-shared mask, so the port
    scores each routed slot with its own ``[rows]`` mask (unrouted slots and
    padded queries give NEG_INF), as the single-device engine does, and
    never builds the pair mask.  Given ``win_start`` / ``win_len`` (host
    ``[M]``, global contiguous row ranges), a slot scores only its range
    within this rank's rows."""
    axes = (slice_axis, dev_axis)
    flat = make_sharded_topk(mesh, k, axes, int8)
    if not pair_mask:
        return flat

    def run(q, emb_l, doc_masks_l, q_valid, doc_valid, *rest, win_start=None,
            win_len=None):
        if int8 != bool(rest):
            raise ValueError("int8=True takes the local row scales, and only then")
        scale_l = rest[0] if int8 else None
        Q, M = q.shape[0], doc_masks_l.shape[0]
        rps = emb_l.shape[0]
        k_l = min(k, rps)
        base = axis_index(mesh, axes) * rps
        dev = q.device
        vals = torch.full((Q, M, k_l), NEG_INF, dtype=torch.float32, device=dev)
        rows = torch.full((Q, M, k_l), -1, dtype=torch.int32, device=dev)
        for m in range(M):
            if not doc_valid[m]:
                continue
            if win_start is not None:
                lo = min(max(int(win_start[m]) - base, 0), rps)
                hi = min(max(int(win_start[m]) + int(win_len[m]) - base, 0), rps)
                if hi <= lo:
                    continue
                v, r = _local_topk(q, emb_l[lo:hi], min(k_l, hi - lo), None,
                                   None if scale_l is None else scale_l[lo:hi],
                                   base + lo)
            else:
                v, r = _local_topk(q, emb_l, k_l, doc_masks_l[m], scale_l, base)
            vals[:, m, : v.shape[1]] = v
            rows[:, m, : r.shape[1]] = r
        qv = q_valid[:, None, None]
        vals = torch.where(qv, vals, torch.full_like(vals, NEG_INF)).reshape(Q * M, k_l)
        rows = torch.where(qv, rows, torch.full_like(rows, -1)).reshape(Q * M, k_l)
        return merge_over(vals, rows, mesh, axes, k)

    return run


def _sharded(q, emb, k, mesh, mask, axis, row_scale, topk):
    int8 = emb.dtype == torch.int8
    if int8 and row_scale is None:
        raise ValueError("int8 emb requires row_scale (see ops/quant.py)")
    if mask is None:
        mask = torch.ones(emb.shape[0], dtype=torch.bool, device=emb.device)
    args = (q, shard_rows(emb, mesh, axis), shard_vec(mask, mesh, axis, False))
    if int8:
        args += (shard_vec(row_scale, mesh, axis, 0.0),)
    return topk(*args)


def hierarchical_dense_topk(
    q: torch.Tensor, emb: torch.Tensor, k: int, mesh: DeviceMesh,
    mask: Optional[torch.Tensor] = None, slice_axis: str = "slice",
    dev_axis: str = "device", row_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard ``emb`` (this rank takes its rows of the padded store) over the
    flattened (slice, device) grid and run the two-level merge; equal to
    :func:`sharded_dense_topk` over the flat mesh."""
    int8 = emb.dtype == torch.int8
    return _sharded(q, emb, k, mesh, mask, (slice_axis, dev_axis), row_scale,
                    make_hierarchical_topk(mesh, k, slice_axis, dev_axis, int8))


def sharded_dense_topk(
    q: torch.Tensor, emb: torch.Tensor, k: int, mesh: DeviceMesh,
    mask: Optional[torch.Tensor] = None, axis: Axes = "data",
    row_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard, search, merge: ``([B, k] vals, [B, k] rows)`` on every rank.
    Pass ``row_scale`` with an int8 ``emb`` (``ops/quant.py``)."""
    int8 = emb.dtype == torch.int8
    return _sharded(q, emb, k, mesh, mask, axis, row_scale,
                    make_sharded_topk(mesh, k, axis, int8))
