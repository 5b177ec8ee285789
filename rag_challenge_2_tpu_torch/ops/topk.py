"""Exact dense inner-product top-k over a device-resident row store.

Port of ``rag_challenge_2_tpu/ops/topk.py``'s ``dense_topk``.  The store
is scored in full f32 and the top-k comes back sorted descending with
ties to the lowest row.  A CUDA tensor goes to kernel K1
(:mod:`.dense_topk`), a CPU tensor to its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -3.0e38  # the reference's masked-score value (not -inf)


def dense_topk(
    q: torch.Tensor,
    emb: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products of each query row against all store rows.

    Args:
        q: ``[B, D]`` f32 queries.
        emb: ``[N, D]`` f32 or bf16 store rows.
        k: neighbours; ``min(k, N)`` are returned.
        mask: optional bool ``[N]`` — False rows score NEG_INF.

    Returns ``(values [B, k_eff] f32, rows [B, k_eff] i32)``, descending.
    """
    if emb.dtype == torch.int8:
        raise NotImplementedError(
            "int8 row stores are not ported yet (ROADMAP A.11)")
    from .dense_topk import dense_topk_fused

    return dense_topk_fused(q, emb, k, mask)
