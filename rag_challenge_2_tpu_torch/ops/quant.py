"""Symmetric per-row int8 quantization of an embedding store.

Port of ``quantize_rows`` from ``rag_challenge_2_tpu/ops/quant.py``: the
int8 IVF stores (``index/ivf.quantize_ivf``, ``build_ivf_streaming(
quantize=True)``) and the query side of ``ivf_search`` need it.  The rest
of that module (int8 flat scoring and the centroid-residual family) is
not ported yet (ROADMAP A.11).
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-12


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
