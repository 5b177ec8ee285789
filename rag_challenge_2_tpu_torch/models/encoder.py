"""Text embedding encoder.

Port of ``rag_challenge_2_tpu/models/encoder.py``: a mean-pooled
transformer encoder over hashed-vocabulary tokens, then a linear
projection and an L2 norm, so inner product == cosine.  Parameters are
f32 and activations bf16, as in the reference.  :class:`Encoder` trains
under autograd (``models/train.py``); :class:`EmbeddingModel` is the
inference wrapper.  Weights cross between the packages in the
reference's ``models/pretrain.save_params`` layout, both ways:
:func:`load_params_npz` + :func:`from_jax_params` read it,
:func:`to_jax_params` writes it.  Random weights are drawn as flax draws
them (:meth:`Encoder.init_weights`).

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

# the std of a standard normal truncated at +-2 (flax's lecun_normal
# divides by it, so the truncated draw keeps a std of 1/sqrt(fan_in))
TRUNC_NORMAL_STD = 0.87962566103423978


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
    moe_experts: int = 0          # >0: odd blocks take a top-2 MoE FFN

    @property
    def vocab_size(self) -> int:
        return 1 << self.vocab_bits


def _layer_norm(x, scale, bias, dtype, eps: float = 1e-6):
    """flax ``LayerNorm``: f32 statistics and affine, result in dtype (one
    fused op forward and backward; the variance is two-pass where flax
    takes E[x^2] - E[x]^2, equal up to f32 rounding)."""
    return F.layer_norm(x.float(), scale.shape, scale, bias, eps).to(dtype)


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
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "moe_experts > 0: the MoE FFN (models/moe.py) is multi-GPU "
                "work, not ported yet (ROADMAP.md, A.14)")
        self.cfg = cfg
        self.tok_embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_len, cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.ln_f = _LayerNorm(cfg.d_model)
        self.proj = nn.Linear(cfg.d_model, cfg.out_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``, from flax's distributions:
        embeddings ``N(0, 1/d_model)`` (``nn.Embed``'s default); every
        dense and attention kernel ``lecun_normal``, a normal of std
        ``1/sqrt(fan_in)/0.8796`` truncated at two of its stds; zero
        biases; LayerNorms at unit scale and zero bias."""
        with torch.no_grad():
            for p in (self.tok_embed, self.pos_embed):
                p.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model),
                          generator=generator)
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    std = 1.0 / math.sqrt(mod.in_features) / TRUNC_NORMAL_STD
                    nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                          2.0 * std, generator=generator)
                    mod.bias.zero_()
            for mod in self.modules():
                if isinstance(mod, _LayerNorm):
                    mod.scale.fill_(1.0)
                    mod.bias.zero_()

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids: i64/i32 [B, L], padded with -1 → f32 [B, out_dim]."""
        c = self.cfg
        dt = c.dtype
        L = token_ids.shape[1]
        pad = token_ids >= 0
        ids = token_ids.clamp(min=0).long()
        # rows gathered, then cast: flax's bf16 table read, without casting
        # the whole table (and its gradient) on every call
        x = (F.embedding(ids, self.tok_embed).to(dt)
             + self.pos_embed[:L].to(dt)[None])
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


def _n_blocks(keys, fmt: str) -> int:
    n = 0
    while fmt.format(n) in keys:
        n += 1
    return n


def _dense_layout(n_blocks: int) -> Dict[str, tuple]:
    """Each reference dense name → (state-dict prefix, whether its kernel
    is attention's out kernel ``[heads, head_dim, out]``, whether its
    kernel and bias split the output into ``[heads, head_dim]``)."""
    out = {"proj": ("proj", False, False)}
    for i in range(n_blocks):
        p, q = f"block{i}", f"blocks.{i}"
        for name in ("query", "key", "value"):
            out[f"{p}/attn/{name}"] = (f"{q}.{name}", False, True)
        out[f"{p}/attn/out"] = (f"{q}.out", True, False)
        out[f"{p}/mlp_in"] = (f"{q}.mlp_in", False, False)
        out[f"{p}/mlp_out"] = (f"{q}.mlp_out", False, False)
    return out


# the reference's names → the state dict's: outside the blocks, then each
# block's LayerNorms (block i: ``block{i}/…`` → ``blocks.{i}.…``)
_PLAIN = {"tok_embed/embedding": "tok_embed", "pos_embed/embedding": "pos_embed",
          "ln_f/scale": "ln_f.scale", "ln_f/bias": "ln_f.bias"}
_BLOCK_NORMS = {f"{ln}/{part}": f"{ln}.{part}"
                for ln in ("ln1", "ln2") for part in ("scale", "bias")}


def to_jax_params(sd: Dict[str, torch.Tensor], n_heads: int) -> Dict[str, np.ndarray]:
    """An :class:`Encoder` state dict → the reference's flat flax params
    (``params/block0/attn/query/kernel`` …, f32 numpy): the exact inverse
    of :func:`from_jax_params`.  ``n_heads`` splits the attention
    kernels back into ``[d_model, heads, head_dim]`` (query / key /
    value, biases ``[heads, head_dim]``) and ``[heads, head_dim,
    d_model]`` (out)."""
    def host(name):
        return sd[name].detach().to("cpu", torch.float32).numpy()

    n = _n_blocks(sd, "blocks.{}.ln1.scale")
    flat = {f"params/{src}": host(dst) for src, dst in _PLAIN.items()}
    for i in range(n):
        flat.update({f"params/block{i}/{src}": host(f"blocks.{i}.{dst}")
                     for src, dst in _BLOCK_NORMS.items()})
    for src, (dst, heads_in, heads_out) in _dense_layout(n).items():
        k = host(dst + ".weight").T                        # [in, out]
        b = host(dst + ".bias")
        if heads_in:
            k = k.reshape(n_heads, -1, k.shape[-1])
        if heads_out:
            k = k.reshape(k.shape[0], n_heads, -1)
            b = b.reshape(n_heads, -1)
        flat[f"params/{src}/kernel"] = k
        flat[f"params/{src}/bias"] = b
    return {k: np.ascontiguousarray(v) for k, v in flat.items()}


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Reference flax params (flat, ``params/block0/attn/query/kernel`` …)
    → an :class:`Encoder` state dict.  Dense kernels are ``[in, out]``
    (the transpose of ``nn.Linear.weight``); attention's query/key/value
    kernels are ``[d_model, heads, head_dim]`` and its out kernel
    ``[heads, head_dim, d_model]``."""
    def get(name):
        return torch.from_numpy(np.array(flat["params/" + name], np.float32))

    n = _n_blocks(flat, "params/block{}/ln1/scale")
    sd: Dict[str, torch.Tensor] = {dst: get(src) for src, dst in _PLAIN.items()}
    for i in range(n):
        sd.update({f"blocks.{i}.{dst}": get(f"block{i}/{src}")
                   for src, dst in _BLOCK_NORMS.items()})
    for src, (dst, heads_in, _) in _dense_layout(n).items():
        k = get(src + "/kernel")
        if heads_in:                   # [heads, head_dim, out] → [in, out]
            k = k.reshape(-1, k.shape[-1])
        else:                          # [in, (heads, head_dim)] → [in, out]
            k = k.reshape(k.shape[0], -1)
        sd[dst + ".weight"] = k.T.contiguous()
        sd[dst + ".bias"] = get(src + "/bias").reshape(-1)
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
