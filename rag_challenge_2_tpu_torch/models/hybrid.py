"""Mamba-2 / attention hybrid backbone, mean-pooled into an embedding.

The backbone of IBM's granite-4.0-h family (``granitemoehybrid``): a
stack of layers whose mixer is a Mamba-2 state-space block or, at the
places ``layer_types`` marks, causal grouped-query attention without
positions; every layer then runs the dropless expert layer of
``models/moe.py`` (routed experts plus a shared one).  With ``x`` the
residual stream and ``m`` the residual multiplier::

    x = embedding_multiplier · E[id]
    each layer:  x += m · Mixer(RMSNorm(x))
                 h = RMSNorm(x);  x += m · (MoE(h) + Shared(h))
    e = Wp · mean over the text's tokens of RMSNorm(x);   e / |e|

The Mamba-2 mixer (one group of B and C, as published): ``in_proj(h)``
splits into z, xBC and dt; ``xBC = SiLU(causal depthwise conv(xBC) +
bias)`` splits into x (``mamba_expand · d_model`` wide: heads of
``mamba_head_dim``), B and C (``mamba_state`` each); ``Δ = softplus(dt +
dt_bias)``, ``A = -exp(A_log)``; per head the state ``S_t = exp(Δ_t A)
S_{t-1} + Δ_t x_t ⊗ B_t`` (``[head_dim, state]``, ``S_0 = 0``) is read
out as ``y_t = S_t C_t + D x_t``; then ``out_proj(RMSNorm(y ⊙ SiLU(z)))``
with one norm group over all heads.  :func:`ssd` computes the
recurrence in its chunked form: within a chunk as masked products, the
state carried from chunk to chunk, so a text longer than a chunk is
right.

Everything is causal and the expert layer drops nothing, so a real
token's result does not depend on the padding after it or on the other
texts of its batch; the expert layer routes the real tokens only.

Numerics: the matrices live in the configuration's type (bf16) and every
large product runs in it; the residual stream, the norms, the conv, the
scan, the router and the projection run in f32 (Mamba's reference code
keeps its residual in f32 too).  Inference only: no training step takes
this backbone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .moe import DroplessMoE

# elements of the largest f32 temporary of the scan (``[texts, heads, Q, Q]``)
SSD_BLOCK = 1 << 27


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of f32 ``x`` over its last dim, in f32."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int) -> torch.Tensor:
    """The Mamba-2 scan without its ``D`` skip, chunked.  f32 ``x [b, l,
    h, p]``, ``dt [b, l, h]`` (after the softplus), ``A [h]`` (negative),
    ``B`` / ``C [b, l, n]`` → ``y [b, l, h, p]``.  Inside a chunk of ``Q``
    positions ``y_i = Σ_{j<=i} exp(a_i - a_j) (C_i · B_j) Δ_j x_j + exp(a_i)
    S C_i``, with ``a`` the running sum of ``Δ A`` from the chunk's start and
    ``S`` the state it starts from; heads go in blocks so that the ``[b,
    heads, Q, Q]`` temporaries stay within ``SSD_BLOCK`` elements."""
    b, l, h, p = x.shape
    xdt = x * dt[..., None]
    a = (dt * A).transpose(1, 2)                                   # [b, h, l]
    y = torch.empty_like(x)
    S = None                                                       # [b, h, p, n]
    for c0 in range(0, l, chunk):
        c1 = min(c0 + chunk, l)
        q = c1 - c0
        Bc, Cc = B[:, c0:c1], C[:, c0:c1]                          # [b, q, n]
        CB = Cc @ Bc.transpose(1, 2)                               # [b, q, q]
        acs = a[:, :, c0:c1].cumsum(-1)                            # [b, h, q]
        above = torch.ones(q, q, dtype=torch.bool, device=x.device).triu(1)
        last = c1 == l
        if S is None and not last:
            S = x.new_zeros(b, h, p, B.shape[-1])
        hb = max(1, min(h, SSD_BLOCK // (b * q * q)))
        for h0 in range(0, h, hb):
            hs = slice(h0, h0 + hb)
            ac = acs[:, hs]                                        # [b, hb, q]
            M = (ac[..., :, None] - ac[..., None, :]).masked_fill_(above, -math.inf)
            M = M.exp_().mul_(CB[:, None])                         # [b, hb, q, q]
            X = xdt[:, c0:c1, hs].transpose(1, 2)                  # [b, hb, q, p]
            Y = M @ X
            if c0 > 0:                       # what the carried state adds
                Y += (Cc[:, None] @ S[:, hs].transpose(-1, -2)) * ac.exp()[..., None]
            if not last:                     # the state after this chunk
                w = (ac[..., -1:] - ac).exp()                      # [b, hb, q]
                S[:, hs] = (S[:, hs] * ac[..., -1].exp()[..., None, None]
                            + (X * w[..., None]).transpose(-1, -2) @ Bc[:, None])
            y[:, c0:c1, hs] = Y.transpose(1, 2)
    return y


class Mamba2Mixer(nn.Module):
    """The Mamba-2 mixer of one layer: ``forward(h [B, L, D])`` in the
    configuration's type → ``[B, L, D]`` in it."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        D, P, N = cfg.d_model, cfg.mamba_head_dim, cfg.mamba_state
        di = cfg.mamba_expand * D
        H = di // P
        self.conv_dim = di + 2 * N
        self.in_proj = nn.Parameter(torch.zeros(2 * di + 2 * N + H, D, dtype=cfg.dtype))
        self.conv_weight = nn.Parameter(torch.zeros(self.conv_dim, cfg.mamba_conv))
        self.conv_bias = nn.Parameter(torch.zeros(self.conv_dim))
        self.dt_bias = nn.Parameter(torch.zeros(H))
        self.A_log = nn.Parameter(torch.zeros(H))
        self.D = nn.Parameter(torch.ones(H))
        self.norm = nn.Parameter(torch.ones(di))
        self.out_proj = nn.Parameter(torch.zeros(D, di, dtype=cfg.dtype))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, L, _ = h.shape
        P, N = c.mamba_head_dim, c.mamba_state
        di = c.mamba_expand * c.d_model
        H = di // P
        with span("encoder.mamba"):
            z, xbc, dt = F.linear(h, self.in_proj).split([di, self.conv_dim, H], -1)
            xbc = F.conv1d(xbc.float().transpose(1, 2), self.conv_weight[:, None],
                           self.conv_bias, padding=c.mamba_conv - 1,
                           groups=self.conv_dim)[..., :L]
            xbc = F.silu(xbc.transpose(1, 2))
            with span("encoder.mamba.scan"):
                x, Bm, Cm = xbc.split([di, N, N], -1)
                x = x.reshape(B, L, H, P)
                dt = F.softplus(dt.float() + self.dt_bias)
                y = ssd(x, dt, -torch.exp(self.A_log), Bm, Cm, c.mamba_chunk)
                y = (y + x * self.D[:, None]).reshape(B, L, di) * F.silu(z.float())
                y = rms_norm(y, self.norm, c.norm_eps)
            return F.linear(y.to(c.dtype), self.out_proj)


class CausalAttention(nn.Module):
    """Causal grouped-query attention without positions: ``n_heads`` query
    heads of ``d_model / n_heads``, one key/value head for every
    ``gqa_group`` of them, scores scaled by ``attention_multiplier``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        D, Hq = cfg.d_model, cfg.n_heads
        hd = D // Hq
        kv = Hq // cfg.gqa_group * hd
        self.q = nn.Parameter(torch.zeros(Hq * hd, D, dtype=cfg.dtype))
        self.k = nn.Parameter(torch.zeros(kv, D, dtype=cfg.dtype))
        self.v = nn.Parameter(torch.zeros(kv, D, dtype=cfg.dtype))
        self.o = nn.Parameter(torch.zeros(D, Hq * hd, dtype=cfg.dtype))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, L, D = h.shape
        Hq = c.n_heads
        hd = D // Hq
        with span("encoder.attention"):
            q = F.linear(h, self.q).view(B, L, Hq, hd).transpose(1, 2)
            k = F.linear(h, self.k).view(B, L, -1, hd).transpose(1, 2)
            v = F.linear(h, self.v).view(B, L, -1, hd).transpose(1, 2)
            a = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=c.gqa_group > 1,
                scale=c.attention_multiplier or 1.0 / math.sqrt(hd))
            return F.linear(a.transpose(1, 2).reshape(B, L, Hq * hd), self.o)


class HybridLayer(nn.Module):
    """One layer: its mixer (``mamba`` or ``attention``), then the expert
    layer with its shared expert, each behind an RMSNorm and scaled by the
    residual multiplier."""

    def __init__(self, cfg, kind: str):
        super().__init__()
        self.cfg = cfg
        self.input_norm = nn.Parameter(torch.ones(cfg.d_model))
        if kind == "mamba":
            self.mamba = Mamba2Mixer(cfg)
        elif kind == "attention":
            self.attn = CausalAttention(cfg)
        else:
            raise ValueError(f"unknown layer type {kind!r}")
        self.post_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.moe = DroplessMoE(cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.moe_top_k,
                               cfg.experts_held, cfg.shared_ff, cfg.dtype)

    def forward(self, x: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
        """``x [B, L, D]`` f32 and the flat indices of its real positions."""
        c = self.cfg
        B, L, D = x.shape
        mixer = self.mamba if hasattr(self, "mamba") else self.attn
        h = rms_norm(x, self.input_norm, c.norm_eps).to(c.dtype)
        x = x + c.residual_multiplier * mixer(h).float()
        h = rms_norm(x, self.post_norm, c.norm_eps).view(B * L, D).index_select(0, real)
        return x.view(B * L, D).index_add(0, real, self.moe(h),
                                          alpha=c.residual_multiplier).view(B, L, D)


class HybridEncoder(nn.Module):
    """The hybrid backbone → unit-norm ``[B, out_dim]`` f32 embeddings of
    ``[B, L]`` ids right-padded with -1 (see the module docstring).  It
    draws no weights of its own: they come from a checkpoint or a
    benchmark's draw."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        types = cfg.layer_types
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype))
        self.layers = nn.ModuleList(HybridLayer(cfg, types[i % len(types)])
                                    for i in range(cfg.n_layers))
        self.norm = nn.Parameter(torch.ones(cfg.d_model))
        self.proj = nn.Linear(cfg.d_model, cfg.out_dim)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, L = token_ids.shape
        pad = token_ids >= 0
        real = pad.reshape(-1).nonzero()[:, 0]
        with span("encoder.forward", positions=B * L, tokens=int(real.numel())):
            x = F.embedding(token_ids.clamp(min=0).long(), self.embed).float()
            x = x * c.embedding_multiplier
            for layer in self.layers:
                x = layer(x, real)
            x = rms_norm(x, self.norm, c.norm_eps)
            pooled = (x * pad[..., None]).sum(1) / pad.sum(1, keepdim=True).clamp(min=1)
            out = self.proj(pooled)
            return out / out.norm(dim=-1, keepdim=True).clamp(min=1e-9)
