"""Kernel K2: posting-span gather (``csrc/span_gather.cu``).

Port of the TPU kernel ``rag_challenge_2_tpu/ops/pallas_bm25.py``
(``gather_posting_spans``), the BM25 front end and the IVF arm's row-id
and scale copy: each (query, term) or (query, probed list) owns the
contiguous span ``[start, start + window)`` of 2 or 3 parallel arrays of
4-byte words, and the kernel copies those spans into one
``[n_arrays, G, window]`` buffer.  Positions are clamped to the array like
the reference's XLA path, so the result equals the plain version bit for
bit on any CSR.

The kernel is bound by bytes, and at the main path's shapes by the chain
of dependent memory round trips a launch makes.  So all of a piece's loads
are in flight at once: one block per work item (span, piece), each thread
issuing every 16-byte load it needs for every array before it stores the
realigned window with 16-byte stores.  :func:`plan` makes the cut (pieces
of at most ``MAX_PIECE`` words) and picks the chunks a thread holds in
Python, so that the CPU tests reach it; the ``.cu`` file's source note
says the rest.

:func:`gather_posting_spans` takes the plain version only for a tensor on
the CPU.  For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..utils import kernels

_LANES = 128
ALIGN = 1024

# the kernel's constants (csrc/span_gather.cu); a card test holds them equal
THREADS = 128
MAX_ARRAYS = 3
MAX_PIECE = 2048            # output words of one work item (8 KB per array)
MAX_CHUNKS = MAX_PIECE // 4 // THREADS   # 16-byte output chunks a thread holds
SPAN_CONSTANTS = (THREADS, MAX_ARRAYS, MAX_PIECE, MAX_CHUNKS)


@dataclass(frozen=True)
class SpanPlan:
    """The launch geometry of one K2 call: one block per (span, piece),
    block ``span * n_pieces + piece``."""

    piece: int          # output words of a work item (the last may be shorter)
    n_pieces: int       # pieces per span
    items: int          # G x n_pieces work items, one block each
    chunks: int         # 16-byte output chunks a thread holds per array: 1, 2 or 4


def plan(G: int, window: int, n_arrays: int) -> SpanPlan:
    """Cut ``G`` spans of ``window`` words into work items of at most
    ``MAX_PIECE`` words (a span of up to ``MAX_PIECE`` is one item; a longer
    one is cut into equal pieces of a multiple of 4 words, so every piece of
    a 16-byte-aligned output row starts aligned) and pick the chunks a
    thread holds: the fewest that cover a piece, so a short piece keeps few
    registers and more blocks fit an SM."""
    if G < 1 or window < 1 or not 2 <= n_arrays <= MAX_ARRAYS:
        raise ValueError(f"K2 plan: G={G}, window={window}, n_arrays={n_arrays}")
    n_pieces = -(-window // MAX_PIECE)
    per = -(-window // n_pieces)
    piece = window if n_pieces == 1 else -(-per // 4) * 4
    n_pieces = -(-window // piece)
    piece_chunks = -(-piece // 4)               # 16-byte chunks of a piece
    need = -(-piece_chunks // THREADS)
    chunks = next(c for c in (1, 2, MAX_CHUNKS) if c >= need)
    return SpanPlan(piece, n_pieces, G * n_pieces, chunks)


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
            P, P, P, ctypes.c_longlong, P, I, I, P, P, P, I, I, I, P]
        lib.rc2_span_gather_constants.restype = None
        lib.rc2_span_gather_constants.argtypes = [P]
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
    if G == 0:
        return tuple(outs)
    cut = plan(G, window, len(arrays))
    src = [a.data_ptr() for a in arrays] + [None] * (3 - len(arrays))
    dst = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    lib = _lib()
    rc = lib.rc2_span_gather(
        *src, n, starts.data_ptr(), G, window, *dst, cut.piece, cut.n_pieces,
        cut.chunks, torch.cuda.current_stream(starts.device).cuda_stream,
    )
    kernels.check_launch(lib, rc, "span_gather")
    gather_posting_spans.launches += 1
    return tuple(outs)


def kernel_constants() -> Tuple[int, ...]:
    """The constants compiled into the kernel (needs the card's build)."""
    out = (ctypes.c_int * len(SPAN_CONSTANTS))()
    _lib().rc2_span_gather_constants(out)
    return tuple(out)


gather_posting_spans.launches = 0
