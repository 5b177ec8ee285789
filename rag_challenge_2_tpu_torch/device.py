"""Device resolution and the numeric settings every entry point relies on.

TF32 is switched off for matmuls and convolutions: the exact dense paths
are specified as full IEEE f32 (the JAX reference scores with
``Precision.HIGHEST``), and the one recall regression the reference
recorded (its IVF probe) was exactly such a silent precision loss.  TF32 keeps about three decimal digits, which reorders
near-tied candidates.
"""

from __future__ import annotations

from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the CUDA card (raises when there is none); a string or
    ``torch.device`` is taken as given.  CPU only when asked for by name:
    a measurement path must never fall back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' explicitly to run the "
                "plain PyTorch versions on the host"
            )
        return torch.device("cuda")
    return torch.device(device)

