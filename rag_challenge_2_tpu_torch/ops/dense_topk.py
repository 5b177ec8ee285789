"""Kernel K1: fused dense score + carried top-k (``csrc/dense_topk.cu``).

Port of the TPU kernel ``rag_challenge_2_tpu/ops/pallas_topk.py``
(``pallas_dense_topk``).  On the H100 it scores f32 queries against an f32
or bf16 row store in IEEE f32 and keeps a per-query top-k on chip, so the
``[B, N]`` score matrix is never written.  A call is one scoring launch
(``scan_float`` of ``csrc/float_scan.cuh``: a persistent grid that reads
the store once for every batch up to 64, TMA stages, a gated carried
top-k) and at most one merge launch; :func:`plan` cuts the call and the
source notes of the two files say what bounds it.

Queries stay f32 against a bf16 store, as the engine's scoring does (it
promotes ``q`` f32 x bf16 rows to f32); the Pallas kernel instead cast
``q`` down to the store's dtype.  The port follows the engine, the path
users run.

:func:`dense_topk_fused` takes the plain version only for a tensor on the
CPU.  For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import device  # noqa: F401  (full-f32 matmuls for the plain version)
from ..utils import kernels
from .float_scan import FloatPlan, float_plan, sm_count
from .topk import NEG_INF, stable_topk

MAX_K = 64
MAX_QUERIES = 64


def dense_topk_plain(
    q: torch.Tensor, emb: torch.Tensor, k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K1: masked f32 scores, then a stable
    descending sort, so ties go to the lowest row.  ``torch.topk`` gives
    no tie order and is not used.  Returns ``(f32 [B, k_eff], i32 [B,
    k_eff])`` with ``k_eff = min(k, N)``."""
    k_eff = min(k, emb.shape[0])
    s = q.float() @ emb.float().T
    if mask is not None:
        m = mask.bool() if mask.dim() == 2 else mask.bool()[None, :]
        s = torch.where(m, s, torch.full_like(s, NEG_INF))
    vals, idx = stable_topk(s, k_eff)
    return vals.contiguous(), idx.to(torch.int32)


_LIB = None


def _lib():
    """The library, its argument types declared once at load."""
    global _LIB
    if _LIB is None:
        lib = kernels.load_library("dense_topk")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rc2_dense_topk.restype = I
        lib.rc2_dense_topk.argtypes = [P, P, I, P] + [I] * 9 + [P] * 5
        lib.rc2_dense_topk_constants.restype = I
        lib.rc2_dense_topk_constants.argtypes = [P, I]
        lib.rc2_dense_topk_stages.restype = I
        lib.rc2_dense_topk_stages.argtypes = [I] * 6
        _LIB = lib
    return _LIB


def library_constants() -> Tuple[int, ...]:
    """The library's own planner constants, in the order of
    ``float_scan.FLOAT_CONSTANTS`` (builds the library)."""
    buf = (ctypes.c_int * 32)()
    n = _lib().rc2_dense_topk_constants(ctypes.cast(buf, ctypes.c_void_p), 32)
    return tuple(buf[:n])


def plan(B: int, N: int, k: int, bf16: bool, sms: int) -> FloatPlan:
    """How K1 cuts a call of ``B <= 64`` queries over ``N`` rows on a card
    of ``sms`` SMs (see ``float_scan.float_plan``): one store pass."""
    if not 1 <= B <= MAX_QUERIES:
        raise ValueError(f"K1 takes 1..{MAX_QUERIES} queries, got {B}")
    return float_plan(B, N, min(k, N), 2 if bf16 else 4, sms)


def _check_cuda_args(q, emb, k, mask) -> None:
    if q.dtype != torch.float32 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError("K1 takes contiguous f32 queries [B, D]")
    if not 1 <= q.shape[0] <= MAX_QUERIES:
        raise ValueError(f"K1 takes 1..{MAX_QUERIES} queries, got {q.shape[0]}")
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K1 takes an f32 or bf16 store, got {emb.dtype}")
    if emb.dim() != 2 or not emb.is_contiguous() or emb.shape[1] != q.shape[1]:
        raise ValueError("K1 takes a contiguous store [N, D] with the query's D")
    if emb.device != q.device:
        raise ValueError("queries and store must be on one device")
    if not 1 <= emb.shape[0] < 2**31:
        raise ValueError(f"K1 takes 1 <= N < 2**31 rows, got {emb.shape[0]}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K1 supports 1 <= k <= {MAX_K}, got {k}")
    if mask is not None and (
        mask.dtype != torch.bool or mask.shape != (emb.shape[0],)
        or not mask.is_contiguous() or mask.device != q.device
    ):
        raise ValueError("K1 takes a contiguous bool row mask [N] on the device")


def dense_topk_fused(
    q: torch.Tensor, emb: torch.Tensor, k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products of each query against every store row.

    Args:
        q: f32 ``[B, D]`` queries, B <= 64.
        emb: f32 or bf16 ``[N, D]`` contiguous row store.
        k: neighbours, 1..64; ``k_eff = min(k, N)`` are returned.
        mask: optional bool ``[N]`` row mask shared by all queries; False
            rows score NEG_INF.

    Returns ``(values f32 [B, k_eff] descending, rows i32 [B, k_eff])``,
    ties to the lowest row.
    """
    if q.device.type == "cpu":
        return dense_topk_plain(q, emb, k, mask)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {q.device}")
    _check_cuda_args(q, emb, k, mask)
    B, D = q.shape
    N = emb.shape[0]
    k_eff = min(k, N)
    bf16 = emb.dtype == torch.bfloat16
    dev = q.device
    pl = plan(B, N, k_eff, bf16, sm_count(dev))
    # one buffer for the blocks' candidate lists (values, then rows) and one
    # for the result
    n_cand = B * pl.n_chunks * k_eff if pl.n_chunks > 1 else 0
    cand = torch.empty(2 * n_cand, dtype=torch.float32, device=dev)
    out = torch.empty((2, B, k_eff), dtype=torch.float32, device=dev)
    out_v, out_i = out[0], out[1].view(torch.int32)
    lib = _lib()
    rc = lib.rc2_dense_topk(
        q.data_ptr(), emb.data_ptr(), int(bf16),
        mask.data_ptr() if mask is not None else None, B, N, D, k_eff,
        pl.query_tile, pl.rows_per_chunk, pl.n_chunks, pl.box_rows,
        pl.blocks_per_sm, cand.data_ptr(), cand.data_ptr() + 4 * n_cand,
        out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check_launch(lib, rc, "dense_topk")
    dense_topk_fused.launches += 1
    return out_v, out_i


dense_topk_fused.launches = 0
