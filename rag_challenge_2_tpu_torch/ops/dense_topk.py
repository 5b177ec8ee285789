"""Kernel K1: fused dense score + running top-k (``csrc/dense_topk.cu``).

Port of the TPU kernel ``rag_challenge_2_tpu/ops/pallas_topk.py``
(``pallas_dense_topk``).  On the H100 it scores f32 queries against an f32
or bf16 row store in IEEE f32 and keeps a per-query top-k on chip, so the
``[B, N]`` score matrix is never written; the source note in the ``.cu``
file says what bounds it (the store read: memory-bound at B = 8) and how
the two passes are laid out.

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


def _lib():
    lib = kernels.load_library("dense_topk")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rc2_dense_topk.restype = I
    lib.rc2_dense_topk.argtypes = [P, P, I, P, I, I, I, I, P, P, P, P, P]
    lib.rc2_dense_topk_tile_rows.restype = I
    lib.rc2_dense_topk_tile_rows.argtypes = []
    lib.rc2_dense_topk_scratch_tiles.restype = I
    lib.rc2_dense_topk_scratch_tiles.argtypes = [I]
    return lib


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
    lib = _lib()
    n_tiles = -(-N // lib.rc2_dense_topk_tile_rows())
    scratch = B * lib.rc2_dense_topk_scratch_tiles(n_tiles) * k_eff
    dev = q.device
    cand_v = torch.empty(scratch, dtype=torch.float32, device=dev)
    cand_i = torch.empty(scratch, dtype=torch.int32, device=dev)
    out_v = torch.empty((B, k_eff), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k_eff), dtype=torch.int32, device=dev)
    rc = lib.rc2_dense_topk(
        q.data_ptr(), emb.data_ptr(), int(emb.dtype == torch.bfloat16),
        mask.data_ptr() if mask is not None else None, B, N, D, k_eff,
        cand_v.data_ptr(), cand_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check_launch(lib, rc, "dense_topk")
    dense_topk_fused.launches += 1
    return out_v, out_i


dense_topk_fused.launches = 0
