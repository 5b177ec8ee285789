"""Text embedding encoder (inference).

Port of ``rag_challenge_2_tpu/models/encoder.py``: a mean-pooled
transformer encoder over hashed-vocabulary tokens, then a linear
projection and an L2 norm, so inner product == cosine.  Parameters are
f32 and activations bf16, as in the reference; weights saved by the
reference's ``models/pretrain.save_params`` load through
:func:`load_params_npz` + :func:`from_jax_params`.

Attention is written out in plain PyTorch: the reference has no kernel
here.  Where flax and torch defaults differ, the reference's numerics are
kept: LayerNorm epsilon 1e-6 with f32 statistics, tanh-approximate GELU,
masking with ``finfo(dtype).min`` (not -inf), softmax in the activation
dtype, embedding tables read out in bf16, and the projection in f32 on
f32 pooled features.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..utils import tokenize as tok


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_bits: int = 15          # 32k hashed vocab (embedding table rows)
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 2048
    max_len: int = 512
    out_dim: int = 1024
    dtype: torch.dtype = torch.bfloat16

    @property
    def vocab_size(self) -> int:
        return 1 << self.vocab_bits


def _layer_norm(x, scale, bias, dtype, eps: float = 1e-6):
    """flax ``LayerNorm``: f32 statistics (fast variance), result in dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


def _dense(x, lin: nn.Linear, dtype):
    """flax ``Dense(dtype=…)``: input, kernel and bias cast to dtype."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class _LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class Block(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.ln1 = _LayerNorm(c.d_model)
        self.query = nn.Linear(c.d_model, c.d_model)
        self.key = nn.Linear(c.d_model, c.d_model)
        self.value = nn.Linear(c.d_model, c.d_model)
        self.out = nn.Linear(c.d_model, c.d_model)
        self.ln2 = _LayerNorm(c.d_model)
        self.mlp_in = nn.Linear(c.d_model, c.d_ff)
        self.mlp_out = nn.Linear(c.d_ff, c.d_model)

    def forward(self, x, mask):
        c = self.cfg
        dt = c.dtype
        B, L, _ = x.shape
        hd = c.d_model // c.n_heads
        h = _layer_norm(x, self.ln1.scale, self.ln1.bias, dt)
        q = _dense(h, self.query, dt).view(B, L, c.n_heads, hd)
        k = _dense(h, self.key, dt).view(B, L, c.n_heads, hd)
        v = _dense(h, self.value, dt).view(B, L, c.n_heads, hd)
        q = q / math.sqrt(hd)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = w.masked_fill(~mask, torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1)
        a = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, c.d_model)
        x = x + _dense(a, self.out, dt)
        h = _layer_norm(x, self.ln2.scale, self.ln2.bias, dt)
        h = F.gelu(_dense(h, self.mlp_in, dt), approximate="tanh")
        return x + _dense(h, self.mlp_out, dt)


class Encoder(nn.Module):
    """Mean-pooled transformer encoder → unit-norm embedding."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_len, cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.ln_f = _LayerNorm(cfg.d_model)
        self.proj = nn.Linear(cfg.d_model, cfg.out_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``: normal embeddings and kernels
        scaled by 1/sqrt(fan_in), zero biases, unit LayerNorm scales."""
        with torch.no_grad():
            for p in (self.tok_embed, self.pos_embed):
                p.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model),
                          generator=generator)
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                                       generator=generator)
                    mod.bias.zero_()

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids: i64/i32 [B, L], padded with -1 → f32 [B, out_dim]."""
        c = self.cfg
        dt = c.dtype
        L = token_ids.shape[1]
        pad = token_ids >= 0
        ids = token_ids.clamp(min=0).long()
        x = self.tok_embed.to(dt)[ids] + self.pos_embed.to(dt)[:L][None]
        mask = (pad[:, None, :, None] & pad[:, None, None, :])  # [B, 1, L, L]
        for blk in self.blocks:
            x = blk(x, mask)
        x = _layer_norm(x, self.ln_f.scale, self.ln_f.bias, dt)
        denom = pad.sum(dim=1, keepdim=True).clamp(min=1).to(dt)
        pooled = (x * pad[..., None].to(dt)).sum(dim=1) / denom
        out = F.linear(pooled.float(), self.proj.weight, self.proj.bias)
        return out / out.norm(dim=-1, keepdim=True).clamp(min=1e-9)


def tokenize_batch(
    texts, max_len: int, vocab_bits: int, bucket_len: bool = False
) -> np.ndarray:
    """Host-side: texts → padded i32 [B, L] hashed-token batch.

    ``bucket_len=True`` pads L to the next power of two ≥ the batch's
    longest text (min 32, cap max_len) instead of always max_len; padding
    is masked, so the embeddings do not change, only the attention width.
    """
    from ..utils.native import tokenize_queries_native

    texts = list(texts)
    out = tokenize_queries_native(texts, vocab_bits, max_len)
    if out is None:
        id_lists = [tok.token_ids(t, vocab_bits)[:max_len] for t in texts]
        out = np.full((len(texts), max_len), -1, np.int32)
        for i, ids in enumerate(id_lists):
            out[i, : len(ids)] = ids
    if bucket_len:
        lens = (out >= 0).sum(axis=1)
        longest = int(lens.max()) if len(texts) else 1
        L = 32
        while L < max(longest, 1):
            L *= 2
        out = out[:, : min(L, max_len)]
    return np.ascontiguousarray(out)


def load_params_npz(path: Path) -> Dict[str, np.ndarray]:
    """The flat ``{tree/path: array}`` dict written by the reference's
    ``models/pretrain.save_params``."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Reference flax params (flat, ``params/block0/attn/query/kernel`` …)
    → an :class:`Encoder` state dict.  Dense kernels are ``[in, out]``
    (the transpose of ``nn.Linear.weight``); attention's query/key/value
    kernels are ``[d_model, heads, head_dim]`` and its out kernel
    ``[heads, head_dim, d_model]``."""
    def get(name):
        return torch.from_numpy(np.array(flat["params/" + name], np.float32))

    def dense(src, dst, sd, reshape_in=False):
        k = get(src + "/kernel")
        b = get(src + "/bias")
        if reshape_in:                 # [heads, head_dim, out] → [in, out]
            k = k.reshape(-1, k.shape[-1])
        else:                          # [in, (heads, head_dim)] → [in, out]
            k = k.reshape(k.shape[0], -1)
        sd[dst + ".weight"] = k.T.contiguous()
        sd[dst + ".bias"] = b.reshape(-1)

    sd: Dict[str, torch.Tensor] = {
        "tok_embed": get("tok_embed/embedding"),
        "pos_embed": get("pos_embed/embedding"),
        "ln_f.scale": get("ln_f/scale"),
        "ln_f.bias": get("ln_f/bias"),
    }
    dense("proj", "proj", sd)
    i = 0
    while f"params/block{i}/ln1/scale" in flat:
        p, q = f"block{i}", f"blocks.{i}"
        for ln in ("ln1", "ln2"):
            sd[f"{q}.{ln}.scale"] = get(f"{p}/{ln}/scale")
            sd[f"{q}.{ln}.bias"] = get(f"{p}/{ln}/bias")
        for name in ("query", "key", "value"):
            dense(f"{p}/attn/{name}", f"{q}.{name}", sd)
        dense(f"{p}/attn/out", f"{q}.out", sd, reshape_in=True)
        dense(f"{p}/mlp_in", f"{q}.mlp_in", sd)
        dense(f"{p}/mlp_out", f"{q}.mlp_out", sd)
        i += 1
    return sd


class EmbeddingModel:
    """Config + weights + batched forward on one device: ``.embed(texts)``
    gives ``[B, out_dim]`` unit-norm f32 embeddings on the host,
    ``.embed_device(texts)`` leaves them on the device."""

    def __init__(
        self,
        cfg: EncoderConfig = EncoderConfig(),
        params: Optional[Dict[str, torch.Tensor]] = None,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.module = Encoder(cfg)
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            self.module.init_weights(generator)
        else:
            self.module.load_state_dict(params)
        self.module.to(self.device).eval()

    @torch.inference_mode()
    def embed_tokens(self, token_ids) -> torch.Tensor:
        ids = torch.as_tensor(token_ids).to(self.device)
        return self.module(ids)

    @torch.inference_mode()
    def embed_device(self, texts, batch_size: int = 256) -> torch.Tensor:
        texts = list(texts)
        outs = []
        for s in range(0, len(texts), batch_size):
            ids = tokenize_batch(texts[s : s + batch_size], self.cfg.max_len,
                                 self.cfg.vocab_bits, bucket_len=True)
            outs.append(self.embed_tokens(torch.from_numpy(ids)))
        if not outs:
            return torch.zeros((0, self.cfg.out_dim), device=self.device)
        return torch.cat(outs)

    def embed(self, texts, batch_size: int = 512) -> np.ndarray:
        return self.embed_device(texts, batch_size).cpu().numpy()
