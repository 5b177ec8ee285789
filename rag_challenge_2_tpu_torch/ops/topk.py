"""Exact dense inner-product top-k over a device-resident row store.

Port of ``rag_challenge_2_tpu/ops/topk.py``.  The store is scored in full
f32 (int8 stores in exact int32 with the dequantization epilogue of
``ops/quant.int8_scores``) and the top-k comes back sorted descending
with ties to the lowest row.  On the card two kernels serve it:

* K1 (:mod:`.dense_topk`) for f32 / bf16 stores and up to 64 queries;
* K3 (:mod:`.stream_topk`) for everything else: int8 stores, larger
  batches, and :func:`blocked_topk`, the bounded-memory exact scan.

Both keep at most :data:`KERNEL_MAX_K` = 64 candidates a query.  A wider
top-k on the card takes :func:`wide_topk`, chosen by k before any launch
(:func:`topk_route`): a row-blocked IEEE-f32 ``torch.matmul`` with a
carried stable top-k, the counterpart of the JAX package's route for
this op (``jnp.dot(precision=HIGHEST)`` + ``lax.top_k``, outside any
Pallas kernel).  A CPU tensor goes to the kernels' plain PyTorch versions.

``lax.approx_max_k`` (the TPU's fused PartialReduce, the JAX package's
``approx_rt`` / ``recall_target`` / engine ``scan_rt``) has no Hopper
counterpart: those arguments are accepted and the top-k is computed
exactly, which is also what JAX computes on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.profiling import NEW, span

NEG_INF = -3.0e38  # the reference's masked-score value (not -inf)

# Rows per step of the plain version of the bounded-memory scan.
BLOCK_ROWS = 1 << 20
# Column count above which the JAX engine sends a window's top-k to its
# approximate mode; kept for the shared configuration surface.
LARGE_TOPK_MIN_COLS = 1 << 19

_IMPLS = ("auto", "xla", "pallas", "blocked")

# The largest k kernels K1 and K3 keep per query.
KERNEL_MAX_K = 64
_STORE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def topk_route(k: int, dtype: torch.dtype, device_type: str) -> str:
    """The path an exact top-k of width ``k`` over a store of ``dtype`` on
    ``device_type`` takes: ``"plain"`` for a CPU tensor (the kernels'
    plain versions), and on the card ``"kernel"`` (K1 or K3) for ``k <=``
    :data:`KERNEL_MAX_K`, ``"wide"`` (:func:`wide_topk`) above."""
    if dtype not in _STORE_DTYPES:
        raise ValueError(f"store dtype must be one of {_STORE_DTYPES}, got {dtype}")
    if device_type != "cuda":
        return "plain"
    return "wide" if k > KERNEL_MAX_K else "kernel"


def wide_topk(
    q: torch.Tensor, emb: torch.Tensor, k: int,
    mask: Optional[torch.Tensor] = None, *, block: int = BLOCK_ROWS, **scores,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wide-k route: ``block`` rows at a time, one IEEE-f32
    ``torch.matmul`` (TF32 is off, ``device.py``) and a stable merge with
    the carried top-k, ties to the lowest row
    (``stream_topk.stream_topk_plain``).  ``scores`` are that function's
    score forms: the int8 ones of ``ops/quant`` (``q_scale``,
    ``row_scale``, ...), or f32 queries against dequantized int8 rows
    (``row_scale`` alone, a traversal hop).  Slots past the eligible rows
    hold row -1 and NEG_INF.  Calls on a CUDA tensor are counted in
    ``wide_topk.launches``."""
    from .stream_topk import stream_topk_plain

    if q.is_cuda:
        wide_topk.launches += 1
    return stream_topk_plain(q, emb, k, mask, block=block, **scores)


wide_topk.launches = 0


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, int64 indices)`` of the k largest along the last axis by
    a stable descending sort: ties go to the lowest index, as in
    ``lax.top_k`` (``torch.topk`` gives no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def large_topk_from_scores(
    scores: torch.Tensor, k: int, approx_rt: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over a materialized ``[B, n]`` score matrix: a stable
    descending sort, ties to the lowest column.  ``approx_rt`` is accepted
    and the result is exact (see the module docstring)."""
    del approx_rt
    vals, idx = stable_topk(scores, min(k, scores.shape[1]))
    return vals.contiguous(), idx.to(torch.int32)


def blocked_topk(
    q: torch.Tensor,
    emb: torch.Tensor,
    k: int,
    row_scale: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    block: int = BLOCK_ROWS,
    assign: Optional[torch.Tensor] = None,
    centroids: Optional[torch.Tensor] = None,
    query_2pass: bool = False,
    approx_rt: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bounded-memory exact scan, through kernel K3 (through
    :func:`wide_topk` on the card when ``k`` > :data:`KERNEL_MAX_K`).

    Args:
        q: ``[B, D]`` f32/bf16 queries (kept in f32 against every store).
        emb: ``[N, D]`` rows, f32, bf16, or int8 with ``row_scale``.
        row_scale: ``[N]`` f32 dequantization scales iff ``emb`` is int8.
        mask: optional ``[N]`` bool (``[B, N]`` on the CPU only).
        block: rows per step of the plain version.
        assign/centroids: centroid-residual store (``ops/quant.py``
            ``quantize_rows_residual``): the exact f32 bias
            ``(q · c)[:, assign]`` is added to the int8 residual score.
        query_2pass: int8 only, the two-level query quantization
            (``ops/quant.quantize_query_2pass``).
        approx_rt: accepted; the scan is exact.

    Returns ``(values [B, k_eff] f32, rows [B, k_eff] i32)``, descending,
    ties to the lowest row; slots past the eligible rows hold row -1 and
    NEG_INF, as the JAX function returns them.
    """
    del approx_rt
    from .quant import quantize_query_2pass, quantize_rows
    from .stream_topk import MAX_QUERIES, stream_topk

    int8 = emb.dtype == torch.int8
    if query_2pass and not int8:
        raise ValueError("query_2pass requires an int8 store")
    if assign is not None and not int8:
        raise ValueError("residual assign/centroids require an int8 store")
    if int8 and row_scale is None:
        raise ValueError("int8 emb requires row_scale (see ops/quant.py)")
    scan = (wide_topk if topk_route(k, emb.dtype, q.device.type) == "wide"
            else stream_topk)
    vals, rows = [], []
    # K3 takes up to 128 queries; quantization and scores are per query,
    # so slices of the batch concatenate to the whole batch's result
    for s0 in range(0, q.shape[0], MAX_QUERIES):
        sl = slice(s0, s0 + MAX_QUERIES)
        m = mask[sl] if mask is not None and mask.dim() == 2 else mask
        with span("dense.code_queries"):
            qf = q[sl].float().contiguous()
            kw = {}
            if int8:
                if query_2pass:
                    q_in, s_hi, s_lo = quantize_query_2pass(qf)
                    kw.update(q_scale=s_hi, q_scale_lo=s_lo)
                else:
                    q_in, kw["q_scale"] = quantize_rows(qf)
                kw["row_scale"] = row_scale
                if assign is not None:
                    kw.update(assign=assign, qc=(qf @ centroids.float().T).contiguous())
            else:
                q_in = qf
        with span("dense.launch"):
            v, r = scan(q_in.contiguous(), emb, k, m, block=block, **kw)
        vals.append(v)
        rows.append(r)
    return torch.cat(vals), torch.cat(rows)


def fill_overflow(vals: torch.Tensor, rows: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Give a streaming scan's overflow slots (row -1) the one-shot
    top-k's rows: masked rows at NEG_INF in ascending row order, as
    ``lax.top_k`` over the masked ``[B, N]`` scores returns them.  All on
    the device, no synchronisation."""
    if mask is None:
        return vals, rows                 # k_eff <= N rows are all eligible
    with span("dense.fill"):
        k = rows.shape[1]
        m = mask if mask.dim() == 2 else mask[None, :]
        excluded = torch.cumsum((~m.bool()).to(torch.int32), dim=1)   # [·, N]
        nth = torch.arange(1, k + 1, dtype=torch.int32, device=rows.device)
        first = torch.searchsorted(excluded.contiguous(),
                                   nth.expand(excluded.shape[0], k).contiguous())
        first = first.expand(rows.shape[0], k)
        slot = torch.arange(k, device=rows.device)[None, :] - (rows >= 0).sum(
            1, keepdim=True)
        fill = torch.gather(first, 1, slot.clamp(min=0)).to(torch.int32)
        return vals, torch.where(rows < 0, fill, rows)


def dense_topk(
    q: torch.Tensor,
    emb: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
    row_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products of each query row against all store rows.

    Args:
        q: ``[B, D]`` f32 queries.
        emb: ``[N, D]`` f32 or bf16 store rows, or int8 with ``row_scale``.
        k: neighbours; ``min(k, N)`` are returned.
        mask: optional bool ``[N]`` (``[B, N]`` on the CPU only) — False
            rows score NEG_INF.
        impl: ``"auto"``, ``"xla"`` and ``"pallas"`` run the exact scan
            (K1 where it takes the call, else K3, on the card
            :func:`wide_topk` for k above :data:`KERNEL_MAX_K`);
            ``"blocked"`` is :func:`blocked_topk` and its -1 overflow rows.
        row_scale: ``[N]`` f32 scales, required iff ``emb`` is int8.

    Returns ``(values [B, k_eff] f32, rows [B, k_eff] i32)`` descending;
    past the eligible rows come masked rows at NEG_INF, lowest first.

    The call is the span ``dense.topk`` (it opens a request when none is
    current): ``dense.code_queries`` and ``dense.launch`` a block of
    queries, ``dense.fill`` under a mask (``utils/profiling.py``).
    """
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    with span("dense.topk", request=NEW) as sp:
        if sp is not None:
            sp.attrs.update(queries=int(q.shape[0]), rows=int(emb.shape[0]), k=int(k),
                            dtype=str(emb.dtype).removeprefix("torch."),
                            route=topk_route(k, emb.dtype, q.device.type))
        if emb.dtype == torch.int8:
            if row_scale is None:
                raise ValueError("int8 emb requires row_scale (see ops/quant.py)")
            from .quant import int8_topk

            return int8_topk(q, emb, row_scale, k, mask)
        if impl == "blocked":
            return blocked_topk(q, emb, k, mask=mask)
        from .dense_topk import MAX_QUERIES, dense_topk_fused

        route = topk_route(k, emb.dtype, q.device.type)
        if route == "plain" or (route == "kernel" and q.shape[0] <= MAX_QUERIES):
            with span("dense.launch"):
                return dense_topk_fused(q, emb, k, mask)
        return fill_overflow(*blocked_topk(q, emb, k, mask=mask), mask)


def approx_topk(
    q: torch.Tensor,
    emb: torch.Tensor,
    k: int,
    recall_target: float = 0.999,
    mask: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's fast large-N scan (``lax.approx_max_k``), same
    contract as :func:`dense_topk`.  ``recall_target`` is accepted and the
    result is exact (see the module docstring)."""
    del recall_target
    return dense_topk(q, emb, k, mask=mask, row_scale=row_scale)
