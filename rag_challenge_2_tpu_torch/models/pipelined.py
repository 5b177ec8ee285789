"""Pipeline-parallel encoder forward (GPipe over the block stack).

Port of ``rag_challenge_2_tpu/models/pipelined.py``.  The encoder's
transformer blocks are homogeneous, so the stack maps onto
``parallel/pipeline.pipeline_forward``: block ``i`` runs on pipe stage
``i``, microbatches stream through with activations rotating one stage a
step, and the embedding, pooling and projection ends run replicated
outside the pipelined region.  dp x pp composes: each microbatch's rows
split over the ``data`` axis inside the same schedule.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.func import functional_call

from ..parallel.pipeline import pipeline_forward
from .encoder import Encoder, EncoderConfig, _layer_norm


def stack_block_params(module: Encoder, n_layers: int) -> Dict[str, torch.Tensor]:
    """``blocks.0 .. blocks.{n-1}`` parameters → one ``{name: [S, ...]}``
    (differentiable: a stage's gradient reaches its block)."""
    blocks = [dict(module.blocks[i].named_parameters()) for i in range(n_layers)]
    return {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}


def encode_pipelined(
    cfg: EncoderConfig,
    module: Encoder,
    token_ids: torch.Tensor,
    mesh: DeviceMesh,
    n_micro: int,
    axis: str = "pipe",
    batch_axis: Optional[str] = "data",
) -> torch.Tensor:
    """Pipelined equivalent of ``Encoder.forward`` (the same weights) on
    the global ``[B, L]`` batch, the same ``[B, out_dim]`` on every rank.

    Requires ``mesh``'s ``axis`` size to equal ``cfg.n_layers`` (one block
    per stage), a dense FFN stack (no MoE: stages must be homogeneous),
    and a batch divisible by ``n_micro``.
    """
    assert cfg.moe_experts == 0, "pipelined encoder requires homogeneous blocks"
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    assert S == cfg.n_layers, (
        f"pipe axis ({S}) must equal n_layers ({cfg.n_layers}) — one stage per block"
    )
    B, L = token_ids.shape
    assert B % n_micro == 0, f"batch {B} not divisible by {n_micro} microbatches"
    dt = cfg.dtype

    pad = token_ids >= 0
    ids = token_ids.clamp(min=0).long()
    x = F.embedding(ids, module.tok_embed).to(dt) + module.pos_embed[:L].to(dt)[None]
    mask = pad[:, None, :, None] & pad[:, None, None, :]            # [B, 1, L, L]

    mb = B // n_micro
    xs = x.reshape(n_micro, mb, L, cfg.d_model)
    masks = mask.reshape(n_micro, mb, *mask.shape[1:])
    block = module.blocks[0]

    def stage_fn(pb, x_mb, m_mb):
        return functional_call(block, pb, (x_mb, m_mb))[0]

    y = pipeline_forward(
        stage_fn, stack_block_params(module, cfg.n_layers), xs, mesh, axis=axis,
        extras=masks,
        batch_axis=batch_axis if batch_axis in mesh.mesh_dim_names else None)
    x = _layer_norm(y.reshape(B, L, cfg.d_model), module.ln_f.scale, module.ln_f.bias, dt)
    denom = pad.sum(dim=1, keepdim=True).clamp(min=1).to(dt)
    pooled = (x * pad[..., None].to(dt)).sum(dim=1) / denom
    out = F.linear(pooled.float(), module.proj.weight, module.proj.bias)
    return out / out.norm(dim=-1, keepdim=True).clamp(min=1e-9)
