"""A mean-pooled pre-LN transformer encoder over hashed token ids, in plain
float32 PyTorch: the architecture of the port's embedding encoder
(``EncoderConfig``, ``Encoder``; the top-2 capacity MoE of its odd blocks
with ``moe_experts > 0``), written from its description.

A configuration's ``model.encoder`` gives ``vocab_bits``, ``d_model``,
``n_layers``, ``n_heads``, ``d_ff``, ``max_len``, ``out_dim`` and
optionally ``moe_experts``.  ``ids`` is an i32 / i64 ``[B, L]`` batch
padded with -1; weights are a dict of f32 tensors under the names of the
program's state dict (``layout``).  The forward, for each text:

    x = tok_embed[id] + pos_embed[position]             (padding: id 0)
    each block:  h = LN1(x);  x += Wo · attention(Wq h, Wk h, Wv h)
                 h = LN2(x);  x += W2 · gelu_tanh(W1 h)   (dense block)
                              x += top-2 MoE(h)           (odd blocks, MoE)
    e = Wp · mean over the text's tokens of LN_f(x);   e / |e|

Attention has ``n_heads`` heads of ``d_model / n_heads``, queries scaled
by ``1/sqrt(head)``; a masked score is set to the f32 minimum (not -inf),
so a padding position's query, whose every key is masked, attends evenly
to all ``L`` positions.  That only matters to the MoE, which routes every
position of the batch, padding included, as the port does: the router
(an f32 linear) picks each token's most probable expert and the most
probable other one (ties to the lower expert); an expert's queue takes
the first choices of all tokens in row-major order, then the second
choices; a choice at or past ``capacity = max(1, int(1.25 T / E))`` of
``T = B L`` tokens is dropped; the kept outputs are weighted by their
softmax probabilities.  The experts are ``gelu_tanh(h W_in[e]) W_out[e]``
without biases.  LayerNorms take epsilon 1e-6.

Departures from the port's numerics, all on purpose (the port computes
in the configuration's activation type, bf16):

* every activation, product, sum, softmax, LayerNorm and expert in f32
  (the port: bf16 activations and residual stream, bf16 softmax, f32
  LayerNorm statistics rounded to bf16, the experts in bf16 whatever the
  encoder's type, the projection in f32 on f32 pooled features);
* TF32 off for every product on the card;
* attention computed in blocks of texts (the same sums, less memory).

``flops`` and ``bytes`` count the useful work of one forward: real tokens
only, attention over each text's own keys.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

CAPACITY_FACTOR = 1.25   # the port's MoE default; the configuration does not carry it
LN_EPS = 1e-6
ATTN_TEXTS = 16          # texts a block of the attention
BIAS_STD = 0.02          # random biases and norm offsets, so the check reads them too
NORM_STD = 0.1


def _sizes(model: dict) -> dict:
    e = model["encoder"]
    return dict(V=1 << int(e["vocab_bits"]), D=int(e["d_model"]), N=int(e["n_layers"]),
                H=int(e["n_heads"]), F=int(e["d_ff"]), max_len=int(e["max_len"]),
                out=int(e["out_dim"]), E=int(e.get("moe_experts", 0)))


def _moe_block(s: dict, i: int) -> bool:
    return s["E"] > 0 and i % 2 == 1


def token_space(model: dict) -> Tuple[int, int]:
    """``(vocabulary size, longest sequence)`` the ids may take."""
    s = _sizes(model)
    return s["V"], s["max_len"]


def compute_type(model: dict) -> str:
    """The torch type the program's products run in, as the configuration
    names it: ``model.encoder.dtype``, bf16 where it names none (the
    port's default).  The MoE's experts run in bf16 whatever it is."""
    return model["encoder"].get("dtype", "torch.bfloat16")


def layout(model: dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """Every weight as ``(name, shape, std, mean)`` of its random draw."""
    s = _sizes(model)
    D, Fd, E = s["D"], s["F"], s["E"]
    out = [("tok_embed", (s["V"], D), D ** -0.5, 0.0),
           ("pos_embed", (s["max_len"], D), D ** -0.5, 0.0)]

    def linear(name, n_in, n_out):
        out.extend([(f"{name}.weight", (n_out, n_in), n_in ** -0.5, 0.0),
                    (f"{name}.bias", (n_out,), BIAS_STD, 0.0)])

    def norm(name):
        out.extend([(f"{name}.scale", (D,), NORM_STD, 1.0), (f"{name}.bias", (D,), NORM_STD, 0.0)])

    for i in range(s["N"]):
        b = f"blocks.{i}"
        norm(f"{b}.ln1")
        for name in ("query", "key", "value", "out"):
            linear(f"{b}.{name}", D, D)
        norm(f"{b}.ln2")
        if _moe_block(s, i):
            out.extend([(f"{b}.moe.w_in", (E, D, Fd), D ** -0.5, 0.0),
                        (f"{b}.moe.w_out", (E, Fd, D), Fd ** -0.5, 0.0)])
            linear(f"{b}.moe.router", D, E)
        else:
            linear(f"{b}.mlp_in", D, Fd)
            linear(f"{b}.mlp_out", Fd, D)
    norm("ln_f")
    linear("proj", D, s["out"])
    return out


def init(model: dict, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Random f32 weights in one draw on ``device``: embeddings
    ``N(0, 1/d_model)``, matrices ``N(0, 1/fan_in)``, biases ``N(0,
    0.02^2)``, norm scales ``N(1, 0.1^2)`` and offsets ``N(0, 0.1^2)``."""
    shapes = layout(model)
    flat = torch.randn(sum(math.prod(sh) for _, sh, _, _ in shapes), generator=generator,
                       device=device)
    out, at = {}, 0
    for name, shape, std, mean in shapes:
        n = math.prod(shape)
        out[name] = (flat[at:at + n].view(shape) * std + mean).contiguous()
        at += n
    return out


def _norm(x, state, name):
    return F.layer_norm(x, x.shape[-1:], state[f"{name}.scale"], state[f"{name}.bias"], LN_EPS)


@torch.no_grad()
def forward(state: Dict[str, torch.Tensor], model: dict, ids: torch.Tensor,
            cast: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """``[B, out_dim]`` f32 unit embeddings of ``ids [B, L]`` (on the
    weights' device).  ``cast`` is applied to both inputs of every matrix
    product (the control's lower precision); None leaves them f32."""
    s = _sizes(model)
    D, H = s["D"], s["H"]
    hd = D // H
    c = cast or (lambda t: t)

    def mm(a, b):
        return c(a) @ c(b)

    def lin(x, name):
        return mm(x, state[f"{name}.weight"].T) + state[f"{name}.bias"]

    dev = state["tok_embed"].device
    ids = ids.to(dev)
    pad = ids >= 0
    B, L = ids.shape
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = state["tok_embed"][ids.clamp(min=0).long()] + state["pos_embed"][:L][None]
        for i in range(s["N"]):
            b = f"blocks.{i}"
            h = _norm(x, state, f"{b}.ln1")
            q, k, v = (lin(h, f"{b}.{n}").view(B, L, H, hd).transpose(1, 2)
                       for n in ("query", "key", "value"))
            q = q / math.sqrt(hd)
            a = torch.empty(B, L, D, device=dev)
            for t in range(0, B, ATTN_TEXTS):
                sl = slice(t, t + ATTN_TEXTS)
                w = mm(q[sl], k[sl].transpose(-1, -2))
                keep = pad[sl, None, :, None] & pad[sl, None, None, :]
                w = torch.softmax(w.masked_fill(~keep, torch.finfo(torch.float32).min), -1)
                a[sl] = mm(w, v[sl]).transpose(1, 2).reshape(-1, L, D)
            x = x + lin(a, f"{b}.out")
            h = _norm(x, state, f"{b}.ln2")
            if _moe_block(s, i):
                x = x + _moe(h.reshape(B * L, D), state, f"{b}.moe", s["E"], mm).view(B, L, D)
            else:
                x = x + lin(F.gelu(lin(h, f"{b}.mlp_in"), approximate="tanh"), f"{b}.mlp_out")
        x = _norm(x, state, "ln_f")
        pooled = (x * pad[..., None]).sum(1) / pad.sum(1, keepdim=True).clamp(min=1)
        e = lin(pooled, "proj")
        return e / e.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _moe(x: torch.Tensor, state, name: str, E: int, mm) -> torch.Tensor:
    """Top-2 capacity routing of the ``[T, D]`` tokens, as the module
    docstring states."""
    T = x.shape[0]
    probs = torch.softmax(mm(x, state[f"{name}.router.weight"].T)
                          + state[f"{name}.router.bias"], -1)
    e1 = probs.argmax(-1)
    g1 = probs.gather(1, e1[:, None])[:, 0]
    other = probs * (1.0 - F.one_hot(e1, E).to(probs.dtype))
    e2 = other.argmax(-1)
    g2 = other.gather(1, e2[:, None])[:, 0]
    first, second = F.one_hot(e1, E), F.one_hot(e2, E)
    p1 = (first.cumsum(0) * first).sum(1) - 1
    p2 = (second.cumsum(0) * second).sum(1) - 1 + first.sum(0)[e2]
    C = max(1, int(CAPACITY_FACTOR * T / E))
    out = torch.zeros_like(x)
    for e in range(E):
        t1, t2 = (e1 == e) & (p1 < C), (e2 == e) & (p2 < C)
        idx = torch.nonzero(t1 | t2)[:, 0]
        if idx.numel() == 0:
            continue
        y = mm(F.gelu(mm(x[idx], state[f"{name}.w_in"][e]), approximate="tanh"),
               state[f"{name}.w_out"][e])
        gate = torch.where(t1[idx], g1[idx], 0.0) + torch.where(t2[idx], g2[idx], 0.0)
        out[idx] += gate[:, None] * y
    return out


def _lengths(ids: torch.Tensor) -> torch.Tensor:
    return (torch.as_tensor(ids) >= 0).sum(1).double()


def flops(model: dict, ids) -> float:
    """The matrix products of one forward over the real tokens: per token
    and block ``8 D^2`` (query, key, value, out) + ``4 D n`` (scores and
    values over the text's own ``n`` keys) + ``4 D F`` (the MLP; a MoE
    block: two experts' ``8 D F`` and the router's ``2 D E``), and per
    text the projection's ``2 D out``."""
    s = _sizes(model)
    D, Fd, E = s["D"], s["F"], s["E"]
    n = _lengths(ids)
    tokens, pairs = float(n.sum()), float((n * n).sum())
    total = 0.0
    for i in range(s["N"]):
        ffn = 8 * D * Fd + 2 * D * E if _moe_block(s, i) else 4 * D * Fd
        total += tokens * (8 * D * D + ffn) + 4 * D * pairs
    return total + 2.0 * D * s["out"] * n.numel()


def bytes(model: dict, ids) -> float:
    """The least bytes of one forward: the ids read; every weight read once
    in f32, of the token table only the distinct rows the batch uses and of
    the position table the longest text's; the embeddings written in f32."""
    s = _sizes(model)
    ids = torch.as_tensor(ids)
    weights = sum(math.prod(sh) for name, sh, _, _ in layout(model)
                  if name not in ("tok_embed", "pos_embed"))
    rows = torch.unique(ids[ids >= 0]).numel() + int(_lengths(ids).max())
    return 4.0 * (ids.numel() + weights + rows * s["D"] + ids.shape[0] * s["out"])
