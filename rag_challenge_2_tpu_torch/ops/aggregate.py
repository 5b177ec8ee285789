"""Hit aggregation + bonus scoring.

Port of ``rag_challenge_2_tpu/ops/aggregate.py`` (``fuse_hits``), the
reference's scoring rule:

    final = base
            * (1 + 0.2 * (distinct_query_hits - 1))      # query-hit bonus
            * (1 + 0.1 * (distinct_methods - 1))          # method diversity

with the same dedup semantics (a query and a method count once per key)
and the same tie rules: ``rep_row`` is the row of the max similarity,
ties to the larger row, and equal final scores come out in ascending key
order.  The reference rides sorts and scans because TPU scatters are
slow; here per-key reductions are ``torch.unique`` + ``scatter_reduce``
over key ids, and (key, query) / (key, method) pairs are int64 composite
keys, which cannot overflow.  Sum-mode per-key totals add at most one
value per method in float64 and round once, so they do not depend on the
order a device adds them in.
"""

from __future__ import annotations

import dataclasses

import torch

from .topk import NEG_INF

_BIG = 2**30

QUERY_BONUS = 0.2
METHOD_BONUS = 0.1


@dataclasses.dataclass
class FusedCandidates:
    """Top-n aggregated candidates, sorted by final score descending."""

    key: torch.Tensor        # i32 [top_n] — page_seg or chunk row (-1 = empty)
    score: torch.Tensor      # f32 [top_n] — final (bonused) score
    base_sim: torch.Tensor   # f32 [top_n] — max similarity as fused (dense
                             # arms pre-scaled by dense_weight)
    n_queries: torch.Tensor  # i32 [top_n] — distinct queries hitting the key
    n_methods: torch.Tensor  # i32 [top_n] — distinct retrieval methods
    rep_row: torch.Tensor    # i32 [top_n] — chunk row achieving the max sim

    def to(self, device) -> "FusedCandidates":
        return FusedCandidates(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def _distinct_per_key(ukeys, key_s, other):
    """Number of distinct ``other`` values per key in ``ukeys`` (sorted)."""
    pairs = torch.unique((key_s.long() << 32) | other.long())
    owner = torch.searchsorted(ukeys, pairs >> 32)
    return torch.bincount(owner, minlength=ukeys.shape[0])


def fuse_hits(
    key: torch.Tensor,
    sim: torch.Tensor,
    qid: torch.Tensor,
    mid: torch.Tensor,
    row: torch.Tensor,
    valid: torch.Tensor,
    *,
    top_n: int,
    mode: str = "max",
) -> FusedCandidates:
    """Aggregate flat ``[L]`` hit lists into bonus-scored, deduped top-n.

    ``mode="max"``: ``base = max(sims over the key)`` (reference parity).
    ``mode="sum"``: ``base = Σ over methods of max(0, per-method max sim)``.
    ``base_sim``/``rep_row`` report the raw max hit in both modes.
    """
    if mode not in ("max", "sum"):
        raise ValueError(f"unknown fuse mode {mode!r}")
    L = key.shape[0]
    dev = key.device
    key_s = torch.where(valid, key.long(), torch.full_like(key.long(), _BIG))
    ukeys, inv = torch.unique(key_s, return_inverse=True)
    nk = ukeys.shape[0]
    sim = sim.float()
    sim_masked = torch.where(key_s < _BIG, sim, torch.full_like(sim, NEG_INF))

    base = torch.full((nk,), NEG_INF, dtype=torch.float32, device=dev)
    base = base.scatter_reduce(0, inv, sim_masked, reduce="amax")
    at_max = sim_masked == base[inv]
    # ties keep the larger row
    no_row = torch.full((L,), -1, dtype=torch.int64, device=dev)
    rep = torch.full((nk,), -1, dtype=torch.int64, device=dev)
    rep = rep.scatter_reduce(
        0, inv, torch.where(at_max, row.long(), no_row), reduce="amax")
    nq = _distinct_per_key(ukeys, key_s, qid)
    nm = _distinct_per_key(ukeys, key_s, mid)

    if mode == "sum":
        pk, pinv = torch.unique((key_s << 32) | mid.long(), return_inverse=True)
        pmax = torch.full((pk.shape[0],), NEG_INF, dtype=torch.float32,
                          device=dev)
        pmax = pmax.scatter_reduce(0, pinv, sim_masked, reduce="amax")
        contrib = torch.where(pmax > NEG_INF / 2, pmax.clamp(min=0.0),
                              torch.zeros_like(pmax)).double()
        owner = torch.searchsorted(ukeys, pk >> 32)
        base_c = torch.zeros((nk,), dtype=torch.float64, device=dev)
        base_c = base_c.index_add(0, owner, contrib).float()
    else:
        base_c = base

    qb = 1.0 + QUERY_BONUS * torch.clamp(nq - 1, min=0).float()
    mb = 1.0 + METHOD_BONUS * torch.clamp(nm - 1, min=0).float()
    live = ukeys < _BIG
    final = torch.where(live, base_c * qb * mb,
                        torch.full_like(base_c, NEG_INF))

    # top-n: stable sort on -final keeps equal scores in ascending key order
    order = torch.sort(-final, stable=True)[1]
    k = min(top_n, L)
    order = order[:k]
    n_live = order.shape[0]
    top = final[order]
    empty = top <= NEG_INF / 2

    def pick(values, fill, dtype):
        out = torch.full((k,), fill, dtype=dtype, device=dev)
        out[:n_live] = torch.where(
            empty, torch.full_like(values[order], fill), values[order]
        ).to(dtype)
        return out

    return FusedCandidates(
        key=pick(ukeys, -1, torch.int32),
        score=pick(final, 0.0, torch.float32),
        base_sim=pick(base, 0.0, torch.float32),
        n_queries=pick(nq, 0, torch.int32),
        n_methods=pick(nm, 0, torch.int32),
        rep_row=pick(rep, -1, torch.int32),
    )
