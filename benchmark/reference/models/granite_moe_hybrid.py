"""IBM's granite-4.0-h hybrid (``granitemoehybrid``) mean-pooled into an
embedding, in plain float32 PyTorch, written from its published
description: Mamba-2 layers with a causal grouped-query attention layer
without positions where ``layer_types`` says, and in every layer a
dropless top-k expert layer with a shared expert.

A configuration's ``model.encoder`` gives the keys of the port's
``EncoderConfig``: ``d_model``, ``n_layers``, ``layer_types`` (one period
of the pattern, repeated over ``n_layers``), ``n_heads`` (query heads of
``d_model / n_heads``), ``gqa_group`` (query heads a key/value head
serves), ``attention_multiplier``, ``mamba_expand`` (the inner width over
``d_model``), ``mamba_head_dim``,
``mamba_state``, ``mamba_conv``, ``moe_experts`` (routed), ``moe_top_k``,
``d_ff`` (a routed expert's width), ``experts_held`` (``[first, end)``),
``shared_ff``, ``norm_eps``, ``embedding_multiplier``,
``residual_multiplier``, ``vocab_rows``, ``max_len``, ``out_dim``.
``ids`` is an i32 / i64 ``[B, L]`` batch right-padded with -1; weights are
a dict of f32 tensors under the names of the program's state dict
(``layout``).  The forward, for each text (``m``: the residual
multiplier; every RMSNorm has its weight and ``norm_eps``):

    x = embedding_multiplier · E[id]
    each layer:  x += m · Mixer(RMSNorm(x))
                 h = RMSNorm(x);  x += m · (MoE(h) + Shared(h))
    e = Wp · mean over the text's tokens of RMSNorm(x) + bp;   e / |e|

Mamba-2 (one group of B and C): ``in_proj · h`` splits into z (heads ·
head_dim), xBC (heads · head_dim + 2 · state) and dt (heads); ``xBC =
SiLU(causal depthwise conv(xBC) + bias)`` splits into x, B and C; per
head ``Δ = softplus(dt + dt_bias)``, ``A = -exp(A_log)``, and position by
position ``S_t = exp(Δ_t A) S_{t-1} + Δ_t x_t ⊗ B_t`` (``S_0 = 0``),
``y_t = S_t C_t + D x_t``: the sequential recurrence, one step a position,
not the chunked form the program computes; then ``out_proj ·
RMSNorm(y ⊙ SiLU(z))`` over all heads at once.  Attention: softmax of
``q · kᵀ · attention_multiplier`` over the text's own earlier positions,
no positions added, key/value head ``j // gqa_group`` for query head
``j``.  The expert layer: router logits ``W_r h`` (no bias) over all
``moe_experts``, the ``moe_top_k`` largest kept and a softmax over them
as the gates; each kept expert adds ``gate · W_out (SiLU(W_g h) ⊙ W_u
h)``; only the experts in ``experts_held`` are computed, as on a device
that holds them under expert parallelism (what the others would add is
left out, as the program leaves it out); the shared expert is the same
GLU at ``shared_ff``, added for every token.

Departures from the published model, and from the program's numerics:

* the head (mean pool over real tokens, the f32 projection to
  ``out_dim``, the L2 norm) is the port's, not the model's LM head;
* every activation, product, sum, softmax and norm in f32, TF32 off (the
  program: bf16 matrices and products, an f32 residual stream, norms,
  conv, scan and router);
* attention, the scan and everything else in blocks of texts of like
  length, each cut to its longest text (the same sums, less memory and
  time); the expert layer routes only the real tokens (a padding
  position's result is never read: everything is causal).

``flops`` and ``bytes`` count the useful work of one forward: real tokens
only, attention over each text's own earlier keys, and the held experts'
work at its expected share, ``moe_top_k · held / moe_experts`` expert GLUs
a token (the routing of random weights is data; its expectation is not).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

TEXTS = 32               # texts a block of the forward
MATRIX_STD = 0.02        # the published initialiser's normal (initializer_range)
NORM_STD = 0.1           # norm weights N(1, 0.1^2), so the check reads them too
BIAS_STD = 0.02
DT_RANGE = (1e-3, 0.1)   # Mamba-2's initial Δ, log-uniform, floored at 1e-4
A_RANGE = (1.0, 16.0)    # Mamba-2's initial -A, uniform


def _sizes(model: dict) -> dict:
    e = model["encoder"]
    P, N = int(e["mamba_head_dim"]), int(e["mamba_state"])
    H = int(e["mamba_expand"]) * int(e["d_model"]) // P
    types = list(e["layer_types"])
    lo, hi = (int(v) for v in e["experts_held"])
    D, Hq = int(e["d_model"]), int(e["n_heads"])
    return dict(V=int(e["vocab_rows"]), D=D, layers=int(e["n_layers"]),
                types=[types[i % len(types)] for i in range(int(e["n_layers"]))],
                Hq=Hq, hd=D // Hq, Hkv=Hq // int(e.get("gqa_group", 1)),
                scale=float(e.get("attention_multiplier") or (D // Hq) ** -0.5),
                H=H, P=P, N=N, di=H * P, conv=H * P + 2 * N, K=int(e.get("mamba_conv", 4)),
                E=int(e["moe_experts"]), k=int(e["moe_top_k"]), F=int(e["d_ff"]),
                Fs=int(e["shared_ff"]), lo=lo, hi=hi, eps=float(e.get("norm_eps", 1e-5)),
                emb_mult=float(e.get("embedding_multiplier", 1.0)),
                res_mult=float(e.get("residual_multiplier", 1.0)),
                max_len=int(e["max_len"]), out=int(e["out_dim"]))


def token_space(model: dict) -> Tuple[int, int]:
    """``(vocabulary size, longest sequence)`` the ids may take."""
    s = _sizes(model)
    return s["V"], s["max_len"]


def compute_type(model: dict) -> str:
    """The torch type the program's products run in, as the configuration
    names it: ``model.encoder.dtype``."""
    return model["encoder"].get("dtype", "torch.bfloat16")


# a draw: ("normal", std, mean), ("uniform", lo, hi), ("A_log",), ("dt_bias",), ("ones",)
def layout(model: dict) -> List[Tuple[str, Tuple[int, ...], tuple]]:
    """Every weight as ``(name, shape, draw)``, in the order they are drawn."""
    s = _sizes(model)
    D = s["D"]
    mat = ("normal", MATRIX_STD, 0.0)
    norm = ("normal", NORM_STD, 1.0)
    conv = ("uniform", -s["K"] ** -0.5, s["K"] ** -0.5)   # nn.Conv1d's own draw
    out = [("embed", (s["V"], D), mat)]
    for i, kind in enumerate(s["types"]):
        p = f"layers.{i}"
        out.append((f"{p}.input_norm", (D,), norm))
        if kind == "mamba":
            m = f"{p}.mamba"
            out += [(f"{m}.in_proj", (2 * s["di"] + 2 * s["N"] + s["H"], D), mat),
                    (f"{m}.conv_weight", (s["conv"], s["K"]), conv),
                    (f"{m}.conv_bias", (s["conv"],), conv),
                    (f"{m}.dt_bias", (s["H"],), ("dt_bias",)),
                    (f"{m}.A_log", (s["H"],), ("A_log",)),
                    (f"{m}.D", (s["H"],), ("ones",)),
                    (f"{m}.norm", (s["di"],), norm),
                    (f"{m}.out_proj", (D, s["di"]), mat)]
        else:
            a = f"{p}.attn"
            out += [(f"{a}.q", (s["Hq"] * s["hd"], D), mat),
                    (f"{a}.k", (s["Hkv"] * s["hd"], D), mat),
                    (f"{a}.v", (s["Hkv"] * s["hd"], D), mat),
                    (f"{a}.o", (D, s["Hq"] * s["hd"]), mat)]
        e = f"{p}.moe"
        out += [(f"{p}.post_norm", (D,), norm),
                (f"{e}.router", (s["E"], D), mat),
                (f"{e}.w_in", (s["hi"] - s["lo"], D, 2 * s["F"]), mat),
                (f"{e}.w_out", (s["hi"] - s["lo"], s["F"], D), mat),
                (f"{e}.shared_in", (D, 2 * s["Fs"]), mat),
                (f"{e}.shared_out", (s["Fs"], D), mat)]
    out += [("norm", (D,), norm), ("proj.weight", (s["out"], D), ("normal", D ** -0.5, 0.0)),
            ("proj.bias", (s["out"],), ("normal", BIAS_STD, 0.0))]
    return out


def _draw(draw: tuple, shape, generator, device) -> torch.Tensor:
    kind = draw[0]
    if kind == "normal":
        return torch.randn(shape, generator=generator, device=device) * draw[1] + draw[2]
    if kind == "ones":
        return torch.ones(shape, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    if kind == "uniform":
        return u * (draw[2] - draw[1]) + draw[1]
    if kind == "A_log":
        return (u * (A_RANGE[1] - A_RANGE[0]) + A_RANGE[0]).log()
    lo, hi = (math.log(v) for v in DT_RANGE)            # dt_bias: softplus⁻¹ of Δ
    dt = (u * (hi - lo) + lo).exp().clamp(min=1e-4)
    return dt + torch.log(-torch.expm1(-dt))


def init(model: dict, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Random f32 weights on ``device``, tensor by tensor in ``layout``'s
    order: matrices ``N(0, 0.02²)`` (the published initialiser's normal);
    norm weights ``N(1, 0.1²)``; the Mamba-2 mixer's own as Mamba-2's
    reference module draws them: the conv ``nn.Conv1d``'s uniform, ``-A``
    uniform in [1, 16], ``Δ`` at the bias log-uniform in [0.001, 0.1],
    ``D`` 1; the port's projection ``N(0, 1/d_model)``, its bias ``N(0,
    0.02²)``."""
    return {name: _draw(draw, shape, generator, device).contiguous()
            for name, shape, draw in layout(model)}


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _glu(a, w_in, w_out, mm):
    g, u = mm(a, w_in).chunk(2, dim=-1)
    return mm(F.silu(g) * u, w_out)


def _mamba(h, st, p, s, mm, c):
    """The Mamba-2 mixer of ``h [b, L, D]``."""
    b, L, _ = h.shape
    H, P, N, di = s["H"], s["P"], s["N"], s["di"]
    z, xbc, dt = mm(h, st[f"{p}.in_proj"].T).split([di, s["conv"], H], -1)
    w, K = st[f"{p}.conv_weight"], s["K"]
    xp = F.pad(xbc, (0, 0, K - 1, 0))                      # causal: K-1 zeros before
    conv = sum(xp[:, j:j + L] * w[:, j] for j in range(K)) + st[f"{p}.conv_bias"]
    x, B, C = F.silu(conv).split([di, N, N], -1)
    x = x.reshape(b, L, H, P)
    dt = F.softplus(dt + st[f"{p}.dt_bias"])               # [b, L, H]
    A = -torch.exp(st[f"{p}.A_log"])
    S = h.new_zeros(b * H, P, N)
    y = torch.empty_like(x)
    for t in range(L):
        u = c(dt[:, t, :, None] * x[:, t]).reshape(b * H, P, 1)
        Bt = c(B[:, t])[:, None, None, :].expand(b, H, 1, N).reshape(b * H, 1, N)
        S = torch.baddbmm(S * torch.exp(dt[:, t] * A).reshape(b * H, 1, 1), u, Bt)
        y[:, t] = (c(S) @ c(C[:, t]).repeat_interleave(H, 0)[..., None]).view(b, H, P)
    y = (y + x * st[f"{p}.D"][:, None]).reshape(b, L, di) * F.silu(z)
    return mm(_rms(y, st[f"{p}.norm"], s["eps"]), st[f"{p}.out_proj"].T)


def _attention(h, st, p, s, mm):
    """Causal grouped-query attention of ``h [b, L, D]``, no positions."""
    b, L, _ = h.shape
    Hq, Hkv, hd = s["Hq"], s["Hkv"], s["hd"]
    q = mm(h, st[f"{p}.q"].T).view(b, L, Hq, hd).transpose(1, 2)
    k = mm(h, st[f"{p}.k"].T).view(b, L, Hkv, hd).transpose(1, 2)
    v = mm(h, st[f"{p}.v"].T).view(b, L, Hkv, hd).transpose(1, 2)
    k, v = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
    w = mm(q, k.transpose(-1, -2)) * s["scale"]
    later = torch.ones(L, L, dtype=torch.bool, device=h.device).triu(1)
    a = mm(torch.softmax(w.masked_fill(later, -math.inf), -1), v)
    return mm(a.transpose(1, 2).reshape(b, L, Hq * hd), st[f"{p}.o"].T)


def _experts(h, st, p, s, mm):
    """The expert layer of the real tokens ``h [T, D]``: the held experts'
    part and the shared expert's."""
    top, idx = mm(h, st[f"{p}.router"].T).topk(s["k"], dim=-1)
    gate = torch.softmax(top, -1)
    out = _glu(h, st[f"{p}.shared_in"], st[f"{p}.shared_out"], mm)
    for e in range(s["lo"], s["hi"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = _glu(h[tok], st[f"{p}.w_in"][e - s["lo"]], st[f"{p}.w_out"][e - s["lo"]], mm)
            out.index_add_(0, tok, gate[tok, slot, None] * y)
    return out


@torch.no_grad()
def forward(state: Dict[str, torch.Tensor], model: dict, ids: torch.Tensor,
            cast: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """``[B, out_dim]`` f32 unit embeddings of ``ids [B, L]`` (on the
    weights' device).  ``cast`` is applied to both inputs of every matrix
    product, the scan's too (the control's lower precision); None leaves
    them f32."""
    s = _sizes(model)
    c = cast or (lambda t: t)

    def mm(a, b):
        return c(a) @ c(b)

    dev = state["embed"].device
    ids = ids.to(dev)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        # texts in blocks of like length, each cut to its longest text (the
        # cut positions are padding; nothing before them reads them)
        n = (ids >= 0).sum(1)
        order = torch.argsort(n, stable=True)
        out = torch.empty(ids.shape[0], s["out"], device=dev)
        for t0 in range(0, ids.shape[0], TEXTS):
            sel = order[t0:t0 + TEXTS]
            blk = ids[sel, :max(1, int(n[sel].max()))]
            real = blk >= 0
            x = state["embed"][blk.clamp(min=0).long()] * s["emb_mult"]
            for i, kind in enumerate(s["types"]):
                p = f"layers.{i}"
                h = _rms(x, state[f"{p}.input_norm"], s["eps"])
                mix = (_mamba(h, state, f"{p}.mamba", s, mm, c) if kind == "mamba"
                       else _attention(h, state, f"{p}.attn", s, mm))
                x = x + s["res_mult"] * mix
                h = _rms(x[real], state[f"{p}.post_norm"], s["eps"])
                x[real] += s["res_mult"] * _experts(h, state, f"{p}.moe", s, mm)
            x = _rms(x, state["norm"], s["eps"])
            pooled = (x * real[..., None]).sum(1) / real.sum(1, keepdim=True).clamp(min=1)
            e = mm(pooled, state["proj.weight"].T) + state["proj.bias"]
            out[sel] = e / e.norm(dim=-1, keepdim=True).clamp(min=1e-9)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _lengths(ids: torch.Tensor) -> torch.Tensor:
    return (torch.as_tensor(ids) >= 0).sum(1).double()


def flops(model: dict, ids) -> float:
    """The products of one forward over the real tokens.  A token, in each
    layer: its mixer (Mamba-2: ``in_proj`` and ``out_proj``, ``2 K`` a
    conv channel, and ``4 · heads · head_dim · state`` for the state's
    update and read-out; attention: the four projections, and ``4 · n_heads
    · head`` a pair of a query and one of its text's earlier keys, itself
    included), the router's ``2 D E``, ``moe_top_k · held / moe_experts``
    expert GLUs of ``6 D d_ff`` and the shared one's ``6 D shared_ff``; a
    text, the projection's ``2 D out``."""
    s = _sizes(model)
    D = s["D"]
    n = _lengths(ids)
    tokens, pairs = float(n.sum()), float((n * (n + 1) / 2).sum())
    mamba = (2 * D * (2 * s["di"] + 2 * s["N"] + s["H"]) + 2 * s["di"] * D
             + 2 * s["K"] * s["conv"] + 4 * s["H"] * s["P"] * s["N"])
    attn = 2 * D * s["hd"] * (2 * s["Hq"] + 2 * s["Hkv"])
    share = s["k"] * (s["hi"] - s["lo"]) / s["E"]
    moe = 2 * D * s["E"] + share * 6 * D * s["F"] + 6 * D * s["Fs"]
    total = 0.0
    for kind in s["types"]:
        if kind == "mamba":
            total += tokens * (mamba + moe)
        else:
            total += tokens * (attn + moe) + 4 * s["Hq"] * s["hd"] * pairs
    return total + 2.0 * D * s["out"] * n.numel()


def bytes(model: dict, ids) -> float:
    """The least bytes of one forward: the ids read; every weight read once
    in the type the program holds it in (the matrices in bf16, the norms,
    the conv, the scan's vectors, the router and the projection in f32),
    of the embedding table only the distinct rows the batch uses; the
    embeddings written in f32."""
    ids = torch.as_tensor(ids)
    half = ("embed", "in_proj", "out_proj", ".q", ".k", ".v", ".o", "w_in", "w_out",
            "shared_in", "shared_out")
    total = 4.0 * ids.numel()
    for name, shape, _ in layout(model):
        if name == "embed":
            total += 2.0 * torch.unique(ids[ids >= 0]).numel() * shape[1]
        else:
            total += (2.0 if name.endswith(half) else 4.0) * math.prod(shape)
    return total + 4.0 * ids.shape[0] * _sizes(model)["out"]
