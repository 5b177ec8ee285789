"""Mixture-of-experts FFN: top-2 routing with a per-expert capacity.

Port of ``rag_challenge_2_tpu/models/moe.py``.  The reference routes each
token to its two most probable experts (ties to the lower expert, as
``lax.top_k`` and ``argmax`` break them), queues the first choices of all
tokens in token order, then the second choices after them, drops what
does not fit an expert's ``capacity = int(1.25 · T / E)`` slots, and adds
a Switch-style load-balance term ``E · Σ_e frac_e · mean_prob_e``.

:func:`top2_dispatch` is the reference's dense form (one-hot ``[T, E, C]``
dispatch and combine tensors), kept for the tests.  :class:`MoEFFN`
computes the same function by index: each (expert, slot) gathers its
token, the experts run as one batched FFN, and each token gathers the
outputs of its two slots.  The dispatch einsum sums one product a slot
(the token itself), so the gather equals it; the combine einsum has at
most two non-zero terms a token, summed here in f32 and rounded to bf16
once, as XLA's bf16 einsum does.  Memory is ``O(T·E + E·C·D)``, not the
dense form's ``O(T·E·C)``, which grows as T² (172 GB at a 512-text corpus
batch of 512 tokens).

The experts run in bf16 whatever the encoder's type (``MoEFFN.dtype``, a
class attribute as in the reference); the router is an f32 ``Linear`` on
f32 input, and the gates are cast to bf16 before the combine.

On a train mesh (``parallel/collectives.ShardPlan``) routing stays global:
each rank routes its own tokens, every rank gathers every token's choices
(and the tokens themselves), queues them in the global batch's row-major
``[B, L]`` order with the global capacity, and the load-balance means run
over the global batch.  The experts split over the ``model`` axis (expert
parallelism): a rank runs its experts on every token routed to them, and
the outputs of all experts are gathered back over ``model`` for the
combine.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import ShardPlan, all_sum, gather


def _route(logits: torch.Tensor):
    """Softmax probabilities and the two choices: ``(probs, e1, g1, e2,
    g2)``; the second choice is the most probable expert but the first
    (``argmax`` takes the first maximum: the reference's tie rule)."""
    probs = torch.softmax(logits, dim=-1)
    E = probs.shape[-1]
    e1 = probs.argmax(dim=-1)
    g1 = probs.gather(-1, e1[:, None])[:, 0]
    masked = probs * (1.0 - F.one_hot(e1, E).to(probs.dtype))
    e2 = masked.argmax(dim=-1)
    g2 = masked.gather(-1, e2[:, None])[:, 0]
    return probs, e1, g1, e2, g2


def _positions(e1: torch.Tensor, e2: torch.Tensor, E: int):
    """Each token's place in its first and its second expert's queue: the
    tokens before it with the same choice, the second choices after every
    first choice of that expert.  (The running counts are ``[E, T]``: a
    scan along a contiguous dim, where one down ``[T, E]``'s columns runs
    E long sequential scans on the card.)"""
    c1 = F.one_hot(e1, E).T.contiguous().cumsum(1)
    c2 = F.one_hot(e2, E).T.contiguous().cumsum(1)
    p1 = c1.gather(0, e1[None])[0] - 1
    p2 = c2.gather(0, e2[None])[0] - 1 + c1[:, -1][e2]
    return p1, p2


def _aux(frac: torch.Tensor, mean_prob: torch.Tensor) -> torch.Tensor:
    return frac.shape[0] * torch.sum(frac * mean_prob)


def top2_dispatch(router_logits: torch.Tensor, capacity: int):
    """The reference's dense routing: ``(dispatch [T, E, C] one-hot,
    combine [T, E, C] gate-weighted, aux)`` for ``[T, E]`` f32 logits.  A
    position at or past ``capacity`` is dropped (the reference's one-hot of
    an out-of-range index is a zero row)."""
    T, E = router_logits.shape
    probs, e1, g1, e2, g2 = _route(router_logits)
    p1, p2 = _positions(e1, e2, E)
    tokens = torch.arange(T, device=router_logits.device)

    def one_expert(e, p, g):
        keep = p < capacity
        d = torch.zeros(T, E, capacity, dtype=probs.dtype, device=probs.device)
        d[tokens[keep], e[keep], p[keep]] = 1.0
        return d, d * g[:, None, None]

    d1, c1 = one_expert(e1, p1, g1)
    d2, c2 = one_expert(e2, p2, g2)
    frac = torch.bincount(e1, minlength=E).to(probs.dtype) / T
    return d1 + d2, c1 + c2, _aux(frac, probs.mean(dim=0))


class MoEFFN(nn.Module):
    """Capacity-routed top-2 MoE feed-forward: ``forward(x[, plan])`` →
    ``(out, aux)`` for ``x`` ``[B, L, D]`` (this rank's tokens on a mesh).
    Expert weights are ``[E, D, F]`` / ``[E, F, D]``; under
    ``parallel/mesh.shard_params`` a rank keeps its experts' rows."""

    dtype = torch.bfloat16

    def __init__(self, n_experts: int, d_model: int, d_ff: int,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.router = nn.Linear(d_model, n_experts)
        self.w_in = nn.Parameter(torch.zeros(n_experts, d_model, d_ff))
        self.w_out = nn.Parameter(torch.zeros(n_experts, d_ff, d_model))

    def capacity(self, T: int) -> int:
        """Slots an expert has when ``T`` tokens are routed together."""
        return max(1, int(self.capacity_factor * T / self.n_experts))

    def routing(self, logits: torch.Tensor) -> torch.Tensor:
        """What the block does with the ``[T, E]`` router logits of T tokens
        routed together: ``[T, 4]`` i64 rows (first expert, second expert,
        whether the capacity keeps the first, and the second)."""
        _, e1, _, e2, _ = _route(logits)
        p1, p2 = _positions(e1, e2, self.n_experts)
        C = self.capacity(logits.shape[0])
        return torch.stack([e1, e2, (p1 < C).long(), (p2 < C).long()], 1)

    def forward(self, x: torch.Tensor, plan: Optional[ShardPlan] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, L, D = x.shape
        E, dt = self.n_experts, self.dtype
        xt = x.reshape(B * L, D)
        logits = self.router(xt.float())
        probs, e1, g1, e2, g2 = _route(logits)
        prob_sum = probs.sum(dim=0)
        xs = xt.to(dt)
        if plan is None:
            mine = torch.arange(B * L, device=x.device)
        else:
            # every token holder's choices and tokens, in global order
            layout, g = plan.token_layout(B, L, x.device)
            order = torch.argsort(layout.reshape(-1))
            e1 = plan.gather_tokens(e1).reshape(-1)[order]
            e2 = plan.gather_tokens(e2).reshape(-1)[order]
            xs = plan.gather_tokens(xs).reshape(-1, D)[order]
            prob_sum = all_sum(all_sum(prob_sum, plan.model if plan.sp else None),
                               plan.data)
            mine = layout[g]
        T = e1.shape[0]
        C = self.capacity(T)
        p1, p2 = _positions(e1, e2, E)
        none = E * C                     # the slot of a dropped choice
        s1 = torch.where(p1 < C, e1 * C + p1, none)
        s2 = torch.where(p2 < C, e2 * C + p2, none)
        tokens = torch.arange(T, device=x.device)
        # the token of each slot; empty slots (and "none") read a zero row.
        # index_select, not indexing: its backward adds by atomics, where
        # indexing's sorts the indices and walks the long run of empty slots
        slot_tok = torch.full((none + 1,), T, dtype=torch.long, device=x.device)
        slot_tok.scatter_(0, s1, tokens)
        slot_tok.scatter_(0, s2, tokens)
        # this rank's experts: all of them, or its rows under expert parallelism
        E_l = self.w_in.shape[0]
        lo = (plan.m if plan is not None and plan.model is not None else 0) * E_l
        rows = torch.cat([xs, xs.new_zeros(1, D)])
        expert_in = rows.index_select(0, slot_tok[lo * C:(lo + E_l) * C]).view(E_l, C, D)
        h = F.gelu(torch.bmm(expert_in, self.w_in.to(dt)), approximate="tanh")
        expert_out = torch.bmm(h, self.w_out.to(dt))
        if plan is not None:
            expert_out = gather(expert_out, plan.model, 0)
        flat = torch.cat([expert_out.reshape(E * C, D), expert_out.new_zeros(1, D)])
        out = (g1.to(dt).float()[:, None] * flat.index_select(0, s1[mine]).float()
               + g2.to(dt).float()[:, None] * flat.index_select(0, s2[mine]).float()).to(dt)
        frac = torch.bincount(e1, minlength=E).float() / T
        return out.reshape(B, L, D), _aux(frac, prob_sum / T)
