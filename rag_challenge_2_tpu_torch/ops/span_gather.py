"""Kernel K2: posting-span gather (``csrc/span_gather.cu``).

Port of the TPU kernel ``rag_challenge_2_tpu/ops/pallas_bm25.py``
(``gather_posting_spans``), the BM25 front end: each query term owns the
contiguous span ``[start, start + window)`` of the CSR arrays, and the
kernel copies those spans with coalesced 16-byte loads instead of a
random per-element gather.  Positions are clamped to the array like the
reference's XLA path, so the result equals the plain version bit for bit
on any CSR.  The source note in the ``.cu`` file says what bounds it.

:func:`gather_posting_spans` takes the plain version only for a tensor on
the CPU.  For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils import kernels

_LANES = 128
ALIGN = 1024


def dma_slack(window: int) -> int:
    """CSR over-allocation beyond ``indptr[-1]`` that the index format
    carries for a gather window (``SparseIndex.dma_pad``).  The value is
    the reference's, so indexes built by either package load in the other;
    the CUDA kernel clamps and does not need it."""
    w_eff = -(-window // _LANES) * _LANES
    return w_eff + ALIGN


def gather_posting_spans_plain(
    chunk_ids: torch.Tensor, tf: torch.Tensor, starts: torch.Tensor, *,
    window: int, dl: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of K2: ``a[clip(start + j, 0, len-1)]``
    for ``j < window``, for each array."""
    offs = torch.arange(window, dtype=torch.int64, device=starts.device)
    pos = (starts.long()[:, None] + offs).clamp(0, chunk_ids.shape[0] - 1)
    arrays = [chunk_ids, tf] + ([dl] if dl is not None else [])
    return tuple(a[pos] for a in arrays)


_LIB = None


def _lib():
    """The library, its argument types declared once at load."""
    global _LIB
    if _LIB is None:
        lib = kernels.load_library("span_gather")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rc2_span_gather.restype = I
        lib.rc2_span_gather.argtypes = [
            P, P, P, ctypes.c_longlong, P, I, I, P, P, P, P]
        _LIB = lib
    return _LIB


def gather_posting_spans(
    chunk_ids: torch.Tensor,
    tf: torch.Tensor,
    starts: torch.Tensor,
    *,
    window: int,
    dl: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Copy ``window``-wide spans of the CSR arrays for every start.

    Args:
        chunk_ids: i32 ``[NNZ_pad]`` CSR row ids.
        tf: f32 ``[NNZ_pad]`` term frequencies.
        starts: i32 ``[G]`` span offsets, one per (query, term).
        dl: optional f32 ``[NNZ_pad]`` per-posting doc lengths.

    Returns ``(ids [G, window] i32, tf [G, window] f32[, dl [G, window]])``.
    """
    if starts.device.type == "cpu":
        return gather_posting_spans_plain(
            chunk_ids, tf, starts, window=window, dl=dl)
    if starts.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {starts.device}")
    arrays = [chunk_ids, tf] + ([dl] if dl is not None else [])
    dtypes = [torch.int32, torch.float32, torch.float32]
    n = chunk_ids.shape[0]
    for a, dt in zip(arrays, dtypes):
        if (a.dtype != dt or a.dim() != 1 or a.shape[0] != n
                or not a.is_contiguous() or a.device != starts.device):
            raise ValueError(
                "K2 takes contiguous 1-D i32 ids and f32 tf/dl of one "
                "length on the device of starts")
    if starts.dtype != torch.int32 or starts.dim() != 1 or not starts.is_contiguous():
        raise ValueError("K2 takes contiguous i32 starts [G]")
    if n < 1 or window < 1:
        raise ValueError("K2 needs a non-empty CSR and window >= 1")
    G = starts.shape[0]
    # one buffer for the 2-3 outputs (all 4-byte types; ids are its i32 view)
    buf = torch.empty((len(arrays), G, window), dtype=torch.float32,
                      device=starts.device)
    outs = [buf[0].view(torch.int32)] + [buf[i] for i in range(1, len(arrays))]
    src = [a.data_ptr() for a in arrays] + [None] * (3 - len(arrays))
    dst = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    lib = _lib()
    rc = lib.rc2_span_gather(
        *src, n, starts.data_ptr(), G, window, *dst,
        torch.cuda.current_stream(starts.device).cuda_stream,
    )
    kernels.check_launch(lib, rc, "span_gather")
    gather_posting_spans.launches += 1
    return tuple(outs)


gather_posting_spans.launches = 0
