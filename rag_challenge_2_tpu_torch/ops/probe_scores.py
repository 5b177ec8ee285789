"""Kernel K4: IVF probe span scores (``csrc/probe_scores.cu``).

Port of the TPU kernel ``rag_challenge_2_tpu/ops/pallas_ivf.py``
(``probe_span_scores``): an IVF probe reads the contiguous row span
``emb_perm[start : start + window]`` of one probed list and scores it
against one query, so the ``[G, window, D]`` gather never exists.  The
source note in the ``.cu`` file says what bounds it (the span read) and
how it is laid out.  Positions are clamped to the store like the
reference's XLA path, so the kernel needs no alignment or slack.

``ROW_ALIGN`` and :func:`dma_slack_rows` are the index format's layout
contract (list starts aligned to 32 rows, slack rows past the last list):
the CUDA kernel does not need them, but builds by either package keep the
same layout so that IVF sidecars load both ways.

:func:`probe_span_scores` takes the plain version only for a tensor on the
CPU.  For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import device  # noqa: F401  (full-f32 products for the plain version)
from ..utils import kernels
from .quant import i8_dot

_LANES = 128
ROW_ALIGN = 32
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_SHARED_BYTES = 48 * 1024


def dma_slack_rows(max_list: int) -> int:
    """Rows an index build allocates past the last list end (the
    reference's value, kept for the shared index format)."""
    w_eff = -(-max(max_list, 1) // _LANES) * _LANES
    return w_eff + 1024 + ROW_ALIGN


def probe_span_scores_plain(
    emb_perm: torch.Tensor, q: torch.Tensor, starts: torch.Tensor, *,
    window: int,
) -> torch.Tensor:
    """The plain PyTorch version of K4: gather the clamped spans, then one
    batched product (exact for int8 codes, ``ops/quant.i8_dot``)."""
    offs = torch.arange(window, dtype=torch.int64, device=starts.device)
    pos = (starts.long()[:, None] + offs).clamp(0, emb_perm.shape[0] - 1)
    rows = emb_perm[pos]                                   # [G, W, D]
    if emb_perm.dtype == torch.int8:
        return i8_dot(q[:, None, :], rows)[:, 0, :]
    return torch.bmm(rows.float(), q.float()[:, :, None])[..., 0]


def _lib():
    lib = kernels.load_library("probe_scores")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rc2_probe_scores.restype = I
    lib.rc2_probe_scores.argtypes = [
        P, P, P, ctypes.c_longlong, I, I, I, I, P, P]
    lib.rc2_probe_scores_rows_per_block.restype = I
    lib.rc2_probe_scores_rows_per_block.argtypes = []
    return lib


def probe_span_scores(
    emb_perm: torch.Tensor, q: torch.Tensor, starts: torch.Tensor, *,
    window: int,
) -> torch.Tensor:
    """Inner products of every query with its contiguous probe span.

    Args:
        emb_perm: ``[N_rows, D]`` f32, bf16 or int8 cluster-ordered rows.
        q: ``[G, D]`` queries in the store's dtype (int8 stores take the
            quantized queries; scales multiply outside).
        starts: i32 ``[G]`` span start rows.
        window: span width (``IVFIndex.max_list``).

    Returns ``[G, window]`` f32 raw dot products (exact int32 sums for
    int8), positions clamped to ``[0, N_rows - 1]``.
    """
    if starts.device.type == "cpu":
        return probe_span_scores_plain(emb_perm, q, starts, window=window)
    if starts.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {starts.device}")
    kind = _KINDS.get(emb_perm.dtype)
    if kind is None:
        raise ValueError(f"K4 takes an f32, bf16 or int8 store, got {emb_perm.dtype}")
    if emb_perm.dim() != 2 or not emb_perm.is_contiguous() or emb_perm.shape[0] < 1:
        raise ValueError("K4 takes a contiguous non-empty store [N_rows, D]")
    G, D = q.shape if q.dim() == 2 else (-1, -1)
    if q.dtype != emb_perm.dtype or D != emb_perm.shape[1] or not q.is_contiguous():
        raise ValueError("K4 takes contiguous queries [G, D] in the store's dtype")
    if (starts.dtype != torch.int32 or starts.shape != (G,)
            or not starts.is_contiguous()):
        raise ValueError("K4 takes contiguous i32 starts [G]")
    if not (emb_perm.device == q.device == starts.device):
        raise ValueError("store, queries and starts must be on one device")
    if window < 1:
        raise ValueError("K4 needs window >= 1")
    if D * emb_perm.element_size() > _MAX_SHARED_BYTES:
        raise ValueError(f"K4 stages one query row in {_MAX_SHARED_BYTES} "
                         f"bytes of shared memory; D={D} is too wide")
    lib = _lib()
    if G * -(-window // lib.rc2_probe_scores_rows_per_block()) >= 2**31:
        raise ValueError("K4 grid too large: split the spans")
    out = torch.empty((G, window), dtype=torch.float32, device=q.device)
    if G == 0:
        return out
    rc = lib.rc2_probe_scores(
        emb_perm.data_ptr(), q.data_ptr(), starts.data_ptr(),
        emb_perm.shape[0], D, kind, G, window, out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check_launch(lib, rc, "probe_scores")
    probe_span_scores.launches += 1
    return out


probe_span_scores.launches = 0
