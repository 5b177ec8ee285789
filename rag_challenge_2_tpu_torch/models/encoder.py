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
them (:meth:`Encoder.init_weights`).  With ``moe_experts > 0`` the odd
blocks take the top-2 MoE FFN of ``models/moe.py``; on a train mesh
(``parallel/mesh.shard_params``) a module holds its rank's shard and its
forward runs the collectives of ``parallel/collectives.py``.

``EncoderConfig(arch="hybrid", ...)`` selects a second backbone, the
Mamba-2 / attention hybrid of ``models/hybrid.py`` (inference only), with
its own fields below; :class:`EmbeddingModel` embeds through either.

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
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..parallel.collectives import ShardPlan, all_sum, gather, sum_scatter
from ..utils import tokenize as tok
from .hybrid import HybridEncoder
from .moe import MoEFFN

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
    moe_experts: int = 0          # >0: odd blocks take a top-2 MoE FFN; hybrid: routed experts
    arch: str = "pre_ln"          # or "hybrid" (models/hybrid.py)
    vocab_rows: int = 0           # >0: a vocabulary of this many rows (hashed ids folded in)
    # the hybrid backbone; ``d_ff`` is its routed experts' width
    layer_types: Tuple[str, ...] = ()   # one period of the layer pattern: "mamba" / "attention"
    gqa_group: int = 1            # query heads that share one key/value head
    attention_multiplier: float = 0.0   # the scores' scale; 0: 1/sqrt(head size)
    mamba_expand: int = 0         # the Mamba-2 inner width over d_model
    mamba_head_dim: int = 0       # inner width / head_dim heads
    mamba_state: int = 0
    mamba_conv: int = 4
    mamba_chunk: int = 256
    moe_top_k: int = 0
    experts_held: Tuple[int, int] = (0, 0)   # the routed experts [first, end) held here
    shared_ff: int = 0            # the shared expert's width
    norm_eps: float = 1e-5
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0

    def __post_init__(self):
        if self.arch not in ("pre_ln", "hybrid"):
            raise ValueError(f"unknown encoder arch {self.arch!r}")
        # a configuration read from JSON gives lists
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        object.__setattr__(self, "experts_held", tuple(self.experts_held))

    @property
    def vocab_size(self) -> int:
        return self.vocab_rows or 1 << self.vocab_bits


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
    """One transformer block: the dense MLP, or with ``use_moe`` the MoE
    FFN (``models/moe.py``).  ``forward(x, mask[, plan])`` → ``(x, aux)``.
    On a train mesh (``plan``) the attention heads and the MLP's hidden
    features are this rank's shard over ``model``: the input projections
    need no collective, the output projections sum over ``model``, and
    under sequence parallelism ``x`` is this rank's part of the sequence,
    gathered before attention and the MLP, the sums scattered back after."""

    def __init__(self, cfg: EncoderConfig, use_moe: bool = False):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.ln1 = _LayerNorm(c.d_model)
        self.query = nn.Linear(c.d_model, c.d_model)
        self.key = nn.Linear(c.d_model, c.d_model)
        self.value = nn.Linear(c.d_model, c.d_model)
        self.out = nn.Linear(c.d_model, c.d_model)
        self.ln2 = _LayerNorm(c.d_model)
        if use_moe:
            self.moe = MoEFFN(c.moe_experts, c.d_model, c.d_ff)
        else:
            self.mlp_in = nn.Linear(c.d_model, c.d_ff)
            self.mlp_out = nn.Linear(c.d_ff, c.d_model)

    @staticmethod
    def _gathered(h, plan):
        return h if plan is None or not plan.sp else gather(h, plan.model, 1)

    def _out(self, h, lin: nn.Linear, plan):
        """The output projection: on a mesh each rank's partial product,
        summed over ``model`` in f32 (scattered over the sequence under
        sequence parallelism), plus the bias."""
        dt = self.cfg.dtype
        if plan is None or plan.model is None:
            return _dense(h, lin, dt)
        part = F.linear(h.to(dt), lin.weight.to(dt)).float()
        part = sum_scatter(part, plan.model, 1) if plan.sp else all_sum(part, plan.model)
        return (part + lin.bias).to(dt)

    def forward(self, x, mask, plan=None):
        c = self.cfg
        dt = c.dtype
        hd = c.d_model // c.n_heads
        h = self._gathered(_layer_norm(x, self.ln1.scale, self.ln1.bias, dt), plan)
        B, L, _ = h.shape
        q = _dense(h, self.query, dt).view(B, L, -1, hd)
        k = _dense(h, self.key, dt).view(B, L, -1, hd)
        v = _dense(h, self.value, dt).view(B, L, -1, hd)
        q = q / math.sqrt(hd)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = w.masked_fill(~mask, torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1)
        a = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, -1)
        x = x + self._out(a, self.out, plan)
        h = _layer_norm(x, self.ln2.scale, self.ln2.bias, dt)
        if hasattr(self, "moe"):
            h, aux = self.moe(h, plan)
            return x + h, aux
        h = F.gelu(_dense(self._gathered(h, plan), self.mlp_in, dt), approximate="tanh")
        return x + self._out(h, self.mlp_out, plan), None


class Encoder(nn.Module):
    """Mean-pooled transformer encoder → unit-norm embedding.

    With ``moe_experts > 0`` the odd blocks take the MoE FFN.  After
    ``parallel/mesh.shard_params(module, mesh)`` the module holds this
    rank's shard of each parameter and its forward runs on this rank's
    rows of a batch (``models/train.py`` splits and gathers the batch);
    ``sequence_parallel`` then splits the sequence over ``model`` between
    blocks (the reference's ``Encoder(cfg, mesh=...)``)."""

    def __init__(self, cfg: EncoderConfig, sequence_parallel: bool = False):
        super().__init__()
        self.cfg = cfg
        self.sequence_parallel = sequence_parallel
        self.mesh = None
        self.tok_embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_len, cfg.d_model))
        self.blocks = nn.ModuleList(
            Block(cfg, use_moe=cfg.moe_experts > 0 and i % 2 == 1)
            for i in range(cfg.n_layers))
        self.ln_f = _LayerNorm(cfg.d_model)
        self.proj = nn.Linear(cfg.d_model, cfg.out_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``, from flax's distributions:
        embeddings ``N(0, 1/d_model)`` (``nn.Embed``'s default); every
        dense and attention kernel ``lecun_normal``, a normal of std
        ``1/sqrt(fan_in)/0.8796`` truncated at two of its stds; zero
        biases; LayerNorms at unit scale and zero bias.  The experts' 3-D
        kernels count the expert axis into the fan-in, as flax's
        ``lecun_normal`` does for ``[E, D, F]``: ``fan_in = D·E``
        (``[E, F, D]``: ``F·E``)."""
        def drawn(p, fill):
            # drawn where the generator lives, then copied in: the same
            # numbers whatever device the module is on
            t = torch.empty(p.shape, device=generator.device)
            fill(t)
            p.copy_(t)

        def lecun(w, fan_in):
            std = 1.0 / math.sqrt(fan_in) / TRUNC_NORMAL_STD
            drawn(w, lambda t: nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                                     generator=generator))

        with torch.no_grad():
            for p in (self.tok_embed, self.pos_embed):
                drawn(p, lambda t: t.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model),
                                             generator=generator))
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    lecun(mod.weight, mod.in_features)
                    mod.bias.zero_()
            for mod in self.modules():
                if isinstance(mod, MoEFFN):
                    for w in (mod.w_in, mod.w_out):
                        lecun(w, w.shape[0] * w.shape[1])
            for mod in self.modules():
                if isinstance(mod, _LayerNorm):
                    mod.scale.fill_(1.0)
                    mod.bias.zero_()

    def forward(self, token_ids: torch.Tensor, return_aux: bool = False):
        """token_ids: i64/i32 [B, L], padded with -1 → f32 [B, out_dim]
        unit-norm; with ``return_aux`` also the summed MoE load-balance
        term of this forward (0 without MoE blocks)."""
        c = self.cfg
        dt = c.dtype
        plan = None if self.mesh is None else ShardPlan.of(self.mesh, self.sequence_parallel)
        L = token_ids.shape[1]
        pad = token_ids >= 0
        ids = token_ids.clamp(min=0).long()
        # rows gathered, then cast: flax's bf16 table read, without casting
        # the whole table (and its gradient) on every call
        x = (F.embedding(ids, self.tok_embed).to(dt)
             + self.pos_embed[:L].to(dt)[None])
        if plan is not None:
            x = gather(x, plan.model, 2)        # the feature-sharded tables
            if plan.sp:
                x = plan.split_seq(x)
        mask = (pad[:, None, :, None] & pad[:, None, None, :])  # [B, 1, L, L]
        aux = torch.zeros((), dtype=torch.float32, device=token_ids.device)
        for blk in self.blocks:
            x, a = blk(x, mask, plan)
            if a is not None:
                aux = aux + a
        if plan is not None and plan.sp:
            x = gather(x, plan.model, 1)
        x = _layer_norm(x, self.ln_f.scale, self.ln_f.bias, dt)
        denom = pad.sum(dim=1, keepdim=True).clamp(min=1).to(dt)
        pooled = (x * pad[..., None].to(dt)).sum(dim=1) / denom
        out = F.linear(pooled.float(), self.proj.weight, self.proj.bias)
        out = out / out.norm(dim=-1, keepdim=True).clamp(min=1e-9)
        return (out, aux) if return_aux else out


# the hash bits folded into a vocabulary that is not a power of two
ROWS_HASH_BITS = 31


def tokenize_batch(
    texts, max_len: int, vocab_bits: int, bucket_len: bool = False, vocab_rows: int = 0
) -> np.ndarray:
    """Host-side: texts → padded i32 [B, L] hashed-token batch.

    ``bucket_len=True`` pads L to the next power of two ≥ the batch's
    longest text (min 32, cap max_len) instead of always max_len; padding
    is masked, so the embeddings do not change, only the attention width.
    ``vocab_rows > 0``: ids in ``[0, vocab_rows)``, each token's 31-bit
    hash taken modulo ``vocab_rows`` (``vocab_bits`` is then not read).
    """
    from ..utils.native import tokenize_queries_native

    texts = list(texts)
    bits = ROWS_HASH_BITS if vocab_rows else vocab_bits
    out = tokenize_queries_native(texts, bits, max_len)
    if out is None:
        id_lists = [tok.token_ids(t, bits)[:max_len] for t in texts]
        out = np.full((len(texts), max_len), -1, np.int32)
        for i, ids in enumerate(id_lists):
            out[i, : len(ids)] = ids
    if vocab_rows:
        out = np.where(out >= 0, out % vocab_rows, -1).astype(np.int32)
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


def _dense_layout(n_blocks: int, moe_blocks) -> Dict[str, tuple]:
    """Each reference dense name → (state-dict prefix, whether its kernel
    is attention's out kernel ``[heads, head_dim, out]``, whether its
    kernel and bias split the output into ``[heads, head_dim]``).  A block
    in ``moe_blocks`` has the MoE router in place of the MLP."""
    out = {"proj": ("proj", False, False)}
    for i in range(n_blocks):
        p, q = f"block{i}", f"blocks.{i}"
        for name in ("query", "key", "value"):
            out[f"{p}/attn/{name}"] = (f"{q}.{name}", False, True)
        out[f"{p}/attn/out"] = (f"{q}.out", True, False)
        if i in moe_blocks:
            out[f"{p}/moe/router"] = (f"{q}.moe.router", False, False)
        else:
            out[f"{p}/mlp_in"] = (f"{q}.mlp_in", False, False)
            out[f"{p}/mlp_out"] = (f"{q}.mlp_out", False, False)
    return out


# the experts' kernels, the same layout in both packages
_EXPERTS = ("w_in", "w_out")


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
    d_model]`` (out).  A MoE block's sown load-balance leaf is written as
    0.0 (the reference's ``load_params`` wants every leaf of its tree)."""
    def host(name):
        return sd[name].detach().to("cpu", torch.float32).numpy()

    n = _n_blocks(sd, "blocks.{}.ln1.scale")
    moe = [i for i in range(n) if f"blocks.{i}.moe.w_in" in sd]
    flat = {f"params/{src}": host(dst) for src, dst in _PLAIN.items()}
    for i in range(n):
        flat.update({f"params/block{i}/{src}": host(f"blocks.{i}.{dst}")
                     for src, dst in _BLOCK_NORMS.items()})
    for i in moe:
        flat.update({f"params/block{i}/moe/{w}": host(f"blocks.{i}.moe.{w}")
                     for w in _EXPERTS})
        # the reference's tree also carries the sown load-balance term,
        # and its load_params looks up every leaf
        flat[f"losses/block{i}/moe/moe_aux/[0]"] = np.zeros((), np.float32)
    for src, (dst, heads_in, heads_out) in _dense_layout(n, moe).items():
        k = host(dst + ".weight").T                        # [in, out]
        b = host(dst + ".bias")
        if heads_in:
            k = k.reshape(n_heads, -1, k.shape[-1])
        if heads_out:
            k = k.reshape(k.shape[0], n_heads, -1)
            b = b.reshape(n_heads, -1)
        flat[f"params/{src}/kernel"] = k
        flat[f"params/{src}/bias"] = b
    return {k: np.ascontiguousarray(v) if v.ndim else v for k, v in flat.items()}


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Reference flax params (flat, ``params/block0/attn/query/kernel`` …)
    → an :class:`Encoder` state dict.  Dense kernels are ``[in, out]``
    (the transpose of ``nn.Linear.weight``); attention's query/key/value
    kernels are ``[d_model, heads, head_dim]`` and its out kernel
    ``[heads, head_dim, d_model]``; the experts' ``w_in`` / ``w_out`` keep
    their layout.  The sown ``losses/…`` leaves are not parameters and are
    not read."""
    def get(name):
        return torch.from_numpy(np.array(flat["params/" + name], np.float32))

    n = _n_blocks(flat, "params/block{}/ln1/scale")
    moe = [i for i in range(n) if f"params/block{i}/moe/w_in" in flat]
    sd: Dict[str, torch.Tensor] = {dst: get(src) for src, dst in _PLAIN.items()}
    for i in range(n):
        sd.update({f"blocks.{i}.{dst}": get(f"block{i}/{src}")
                   for src, dst in _BLOCK_NORMS.items()})
    for i in moe:
        sd.update({f"blocks.{i}.moe.{w}": get(f"block{i}/moe/{w}") for w in _EXPERTS})
    for src, (dst, heads_in, _) in _dense_layout(n, moe).items():
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
    ``.embed_device(texts)`` leaves them on the device.  Each batch of
    texts of a MoE encoder is padded with rows of -1 to the reference's
    :meth:`_bucket` rows, and the padding rows are dropped after: a MoE
    encoder routes every token of the batch, padding included, so its
    embeddings depend on the batch's shape.  A dense encoder's rows are
    independent, so its batches go unpadded, as do the hybrid's (its
    expert layer drops nothing and routes real tokens only).

    The module is built on its device, its parameters in the types it
    declares (the hybrid's matrices in ``cfg.dtype``), and ``params`` are
    copied in once, cast where the types differ; the preset's random
    weights are drawn where ``generator`` lives and copied in tensor by
    tensor."""

    def __init__(
        self,
        cfg: EncoderConfig = EncoderConfig(),
        params: Optional[Dict[str, torch.Tensor]] = None,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.device("meta"):
            module = HybridEncoder(cfg) if cfg.arch == "hybrid" else Encoder(cfg)
        self.module = module.to_empty(device=self.device)
        if params is None:
            if cfg.arch == "hybrid":
                raise ValueError("the hybrid backbone draws no weights: pass them as params")
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            self.module.init_weights(generator)
        else:
            self.module.load_state_dict(params)
        self.module.eval()

    @torch.inference_mode()
    def embed_tokens(self, token_ids) -> torch.Tensor:
        ids = torch.as_tensor(token_ids).to(self.device)
        return self.module(ids)

    @staticmethod
    def _bucket(n: int, batch_size: int) -> int:
        """The rows a batch of ``n`` texts is padded to: the next power of
        two, at least 8, at most ``batch_size``."""
        b = 8
        while b < min(n, batch_size):
            b *= 2
        return min(b, batch_size)

    @torch.inference_mode()
    def embed_device(self, texts, batch_size: int = 256) -> torch.Tensor:
        texts = list(texts)
        outs = []
        for s in range(0, len(texts), batch_size):
            chunk = texts[s : s + batch_size]
            ids = tokenize_batch(chunk, self.cfg.max_len, self.cfg.vocab_bits,
                                 bucket_len=True, vocab_rows=self.cfg.vocab_rows)
            if self.cfg.moe_experts > 0 and self.cfg.arch == "pre_ln":
                rows = self._bucket(len(chunk), batch_size)
                ids = np.pad(ids, ((0, rows - len(chunk)), (0, 0)), constant_values=-1)
            outs.append(self.embed_tokens(torch.from_numpy(ids))[: len(chunk)])
        if not outs:
            return torch.zeros((0, self.cfg.out_dim), device=self.device)
        return torch.cat(outs)

    def embed(self, texts, batch_size: int = 512) -> np.ndarray:
        return self.embed_device(texts, batch_size).cpu().numpy()
