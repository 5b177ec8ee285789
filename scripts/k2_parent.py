"""The span gather (K2) before its redesign, as a timing baseline.

``scripts/k2_parent.cu`` is the kernel that the redesigned
``rag_challenge_2_tpu_torch/csrc/span_gather.cu`` replaced: one block per
span, array after array.  :func:`gather` launches it with the wrapper's
contract (one ``[n_arrays, G, window]`` buffer), so ``chip_smoke.py`` and
``scripts/k2_sweep.py`` can time the old and the new kernel under one timer
and hold both against the plain version.  The port never calls it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

SRC = Path(__file__).resolve().with_name("k2_parent.cu")
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from rag_challenge_2_tpu_torch.utils import kernels

        lib = kernels.load_library("k2_parent", SRC)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rc2_span_gather.restype = I
        lib.rc2_span_gather.argtypes = [P, P, P, ctypes.c_longlong, P, I, I, P, P, P, P]
        _LIB = lib
    return _LIB


def gather(chunk_ids, tf, starts, *, window, dl=None):
    """The parent kernel on CUDA tensors: ``(ids, tf[, dl])`` spans."""
    import torch

    from rag_challenge_2_tpu_torch.utils import kernels

    arrays = [chunk_ids, tf] + ([dl] if dl is not None else [])
    G = starts.shape[0]
    buf = torch.empty((len(arrays), G, window), dtype=torch.float32, device=starts.device)
    outs = [buf[0].view(torch.int32)] + [buf[i] for i in range(1, len(arrays))]
    src = [a.data_ptr() for a in arrays] + [None] * (3 - len(arrays))
    dst = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    lib = _lib()
    rc = lib.rc2_span_gather(*src, chunk_ids.shape[0], starts.data_ptr(), G, window, *dst,
                             torch.cuda.current_stream(starts.device).cuda_stream)
    kernels.check_launch(lib, rc, "k2_parent")
    return tuple(outs)
