"""Symmetric per-row int8 quantization of an embedding store.

Port of ``rag_challenge_2_tpu/ops/quant.py``: the per-row int8 store
(``quantize_rows``, ``int8_scores``, ``int8_topk``), the two-level query
(``quantize_query_2pass``) and the centroid-residual family
(``quantize_rows_residual``, ``int8_residual_*``).  An int8 store keeps
the inner product exact in int32 and applies the dequantization as a
rank-1 epilogue:

    score(q, x) ≈ (sq · sx) · Σ round(q/sq)·round(x/sx)

Every scan goes through kernel K3 (``ops/stream_topk.py``) on the card,
which computes the epilogue in the same order as the JAX package, so
int8 scores are bitwise equal to its.  The full-matrix score functions
and the rescoring stage stay plain PyTorch, as they are plain XLA there;
every plain int8 product goes through :func:`i8_dot` and
:func:`int8_epilogue`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import device  # noqa: F401  (full-f32 matmuls)
from .topk import NEG_INF, stable_topk

_EPS = 1e-12
# largest D for which every partial sum of an int8 x int8 dot stays an
# integer below 2**24, so an f32 product is exact: 127**2 * 1040 < 2**24
I8_EXACT_F32_DIM = 1040


def i8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 dot products over the last axis: ``a @ bᵀ`` as f32
    ``[..., m, n]`` for codes ``a [..., m, D]`` and ``b [..., n, D]``.
    The codes multiply as f32, exact while D <= 1040; wider rows multiply
    as f64, exact for any D (CUDA has no integer matmul).  Each sum is
    rounded to f32 once, as the JAX package's int32 sum is."""
    dt = torch.float32 if a.shape[-1] <= I8_EXACT_F32_DIM else torch.float64
    return torch.matmul(a.to(dt), b.to(dt).transpose(-1, -2)).float()


def int8_epilogue(
    acc: torch.Tensor, row_scale: torch.Tensor, q_scale: torch.Tensor,
    q_scale_lo: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dequantize exact int8 dot products ``acc [B, n]`` in the JAX
    package's order: ``(acc · q_scale) · row_scale``, or, for the 2-pass
    query (``acc`` stacks ``[hi; lo]``, ``2B`` rows), ``(hi · s_hi + lo ·
    s_lo) · row_scale``.  ``row_scale`` broadcasts against ``[B, n]``."""
    if q_scale_lo is None:
        return acc * q_scale[:, None] * row_scale
    B = q_scale.shape[0]
    return (acc[:B] * q_scale[:, None] + acc[B:] * q_scale_lo[:, None]) * row_scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: ``(q int8 [..., D], scale f32 [...])`` with
    ``x ≈ q * scale[..., None]``.  All-zero rows get scale 0 and codes 0.
    ``torch.round`` rounds half to even, like ``jnp.round``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    inv = torch.where(scale > _EPS, 1.0 / scale.clamp(min=_EPS),
                      torch.zeros_like(scale))
    q = torch.round(xf * inv[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_query_2pass(
    q: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-level int8 query quantization, ``q ≈ s_hi·q8_hi + s_lo·q8_lo``:
    the residual of the first pass is quantized again.  Returns
    ``(q8 [2B, D] int8 = [hi; lo], s_hi [B], s_lo [B])``."""
    qf = q.float()
    q_hi, s_hi = quantize_rows(qf)
    resid = qf - q_hi.float() * s_hi[..., None]
    q_lo, s_lo = quantize_rows(resid)
    return torch.cat([q_hi, q_lo]), s_hi, s_lo


def int8_scores(q: torch.Tensor, emb_i8: torch.Tensor,
                row_scale: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` f32 scores of f32/bf16 queries against an int8 row
    store: quantize each query, exact int8 dot, ``(acc · q_scale) ·
    row_scale``."""
    q8, q_scale = quantize_rows(q.float())
    return int8_epilogue(i8_dot(q8, emb_i8), row_scale[None, :], q_scale)


def quantize_rows_residual(
    x: torch.Tensor, centroids: torch.Tensor,
    assign: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Centroid-residual int8: ``x ≈ centroids[assign] + q * scale[:, None]``.

    Args:
        x: ``[N, D]`` rows.
        centroids: ``[K, D]`` f32 codebook (k-means of the corpus).
        assign: optional ``[N]`` i32 nearest-centroid ids; computed with
            ``ops/kmeans.assign_clusters`` when absent.

    Returns ``(q int8 [N, D], scale f32 [N], assign i32 [N])``.
    """
    xf = x.float()
    if assign is None:
        from .kmeans import assign_clusters

        assign = assign_clusters(xf, centroids)
    q, scale = quantize_rows(xf - centroids.float()[assign.long()])
    return q, scale, assign


def int8_residual_scores(
    q: torch.Tensor, emb_i8: torch.Tensor, row_scale: torch.Tensor,
    assign: torch.Tensor, centroids: torch.Tensor,
) -> torch.Tensor:
    """``[B, N]`` f32 scores against a centroid-residual int8 store: the
    exact f32 centroid part ``(q · c)[:, assign]`` plus the int8 residual
    score."""
    qc = q.float() @ centroids.float().T
    return qc[:, assign.long()] + int8_scores(q, emb_i8, row_scale)


def int8_residual_topk(
    q: torch.Tensor, emb_i8: torch.Tensor, row_scale: torch.Tensor,
    assign: torch.Tensor, centroids: torch.Tensor, k: int,
    mask: Optional[torch.Tensor] = None, query_2pass: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-scan top-k against a centroid-residual int8 store: the
    bounded-memory scan (``ops/topk.blocked_topk``, kernel K3) with the
    residual bias, by default with the 2-pass query."""
    from .topk import blocked_topk

    return blocked_topk(q, emb_i8, k, row_scale=row_scale, mask=mask,
                        assign=assign, centroids=centroids,
                        query_2pass=query_2pass)


def int8_residual_approx_topk(
    q: torch.Tensor, emb_i8: torch.Tensor, row_scale: torch.Tensor,
    assign: torch.Tensor, centroids: torch.Tensor, k: int,
    recall_target: float = 0.95, mask: Optional[torch.Tensor] = None,
    query_2pass: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's fast tier of the residual scan; ``recall_target``
    is accepted and the scan is exact (``ops/topk.py``)."""
    from .topk import blocked_topk

    return blocked_topk(q, emb_i8, k, row_scale=row_scale, mask=mask,
                        assign=assign, centroids=centroids,
                        query_2pass=query_2pass, approx_rt=recall_target)


def int8_residual_topk_rescored(
    q: torch.Tensor, emb_i8: torch.Tensor, row_scale: torch.Tensor,
    assign: torch.Tensor, centroids: torch.Tensor, k: int,
    k_cand: int = 48, recall_target: float = 0.95,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage residual scan: ``k_cand`` candidates by the 1-pass scan
    (kernel K3), then the ``[B, k_cand, D]`` candidate rows rescored with
    the exact centroid bias and the 2-pass query (plain PyTorch, as it is
    plain XLA in the JAX package).  Candidate slots of row -1 (fewer
    eligible rows than ``k_cand``) stay out."""
    from .topk import blocked_topk

    n = emb_i8.shape[0]
    k = min(k, n)
    k_cand = min(max(k_cand, k), n)
    _, cand = blocked_topk(q, emb_i8, k_cand, row_scale=row_scale,
                           mask=mask, assign=assign, centroids=centroids,
                           query_2pass=False, approx_rt=recall_target)
    ok = cand >= 0
    safe = torch.where(ok, cand, torch.zeros_like(cand)).long()
    rows = emb_i8[safe]                                   # [B, kc, D] int8
    sc = row_scale[safe]                                  # [B, kc]
    qc = q.float() @ centroids.float().T
    bias = torch.gather(qc, 1, assign[safe].long())       # [B, kc]
    q2, s_hi, s_lo = quantize_query_2pass(q)
    B, D = q.shape
    # each query's [hi, lo] codes against its own candidate rows
    acc = i8_dot(q2.reshape(2, B, D).transpose(0, 1), rows)   # [B, 2, kc]
    resid = int8_epilogue(acc.transpose(0, 1).reshape(2 * B, -1), sc, s_hi, s_lo)
    scores = torch.where(ok, bias + resid, torch.full_like(resid, NEG_INF))
    vals, j = stable_topk(scores, k)
    out_rows = torch.gather(torch.where(ok, cand, torch.full_like(cand, -1)), 1, j)
    return vals.contiguous(), out_rows.to(torch.int32)


def int8_topk(
    q: torch.Tensor, emb_i8: torch.Tensor, row_scale: torch.Tensor, k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-scan top-k against an int8 row store (kernel K3 on the card).

    Args:
        q: ``[B, D]`` f32/bf16 queries (quantized here, per query row).
        emb_i8: ``[N, D]`` int8 rows; ``row_scale``: ``[N]`` f32 scales.
        k: neighbours; ``min(k, N)`` are returned.
        mask: optional ``[N]`` routing mask (``[B, N]`` on the CPU only).

    Returns ``(values [B, k_eff] f32, rows [B, k_eff] i32)``, descending,
    with the one-shot top-k's overflow slots: masked rows at NEG_INF.
    """
    from .topk import blocked_topk, fill_overflow

    return fill_overflow(*blocked_topk(q, emb_i8, k, row_scale=row_scale,
                                       mask=mask), mask)
