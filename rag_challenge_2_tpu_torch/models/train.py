"""Contrastive training for the embedding encoder, on one device.

Port of ``rag_challenge_2_tpu/models/train.py``: symmetric InfoNCE over
(query, passage) pairs with in-batch negatives (the ``q @ d.T`` logits),
optionally with soft listwise targets, and AdamW over every parameter
with the reference's learning-rate schedule.  The reference shards the
batch and the weights over a mesh; here one device holds both, and
``TrainConfig.sequence_parallel`` / ``pp_microbatches`` (which act only
on a mesh there) are accepted and do nothing (multi-GPU is ROADMAP.md's
A.14).

A step launches its work and returns its metrics as 0-d tensors on the
device: nothing in it waits for the device, so the host can prepare the
next batch while the device runs this one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .encoder import Encoder, EncoderConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 0.01
    temperature: float = 0.05
    sequence_parallel: bool = False  # shard sequence axis over 'model' too
    moe_aux_weight: float = 0.01     # Switch-style load-balance coefficient
    pp_microbatches: int = 2         # GPipe microbatches when mesh has 'pipe'
    # lr schedule: total_steps > 0 switches the constant lr to linear
    # warmup (warmup_steps) → cosine decay to lr*min_lr_frac at
    # total_steps — long pretraining runs (models/pretrain.py) plateau
    # under a constant lr once the contrastive task sharpens
    total_steps: int = 0
    warmup_steps: int = 100
    min_lr_frac: float = 0.05


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """The learning rate of an update, by the count of updates done before
    it: ``tc.lr`` throughout, or, with ``total_steps > 0``, optax's
    ``warmup_cosine_decay_schedule(0, lr, warmup, total_steps,
    lr * min_lr_frac)`` with ``warmup = min(warmup_steps,
    max(total_steps // 10, 1))`` (so the first update has lr 0)."""
    if tc.total_steps <= 0:
        return lambda count: tc.lr
    warmup = min(tc.warmup_steps, max(tc.total_steps // 10, 1))
    decay = tc.total_steps - warmup
    if decay <= 0:
        raise ValueError(
            f"the cosine decay needs total_steps > warmup ({tc.total_steps} "
            f"<= {warmup})")
    peak, end = tc.lr, tc.lr * tc.min_lr_frac
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:                       # linear 0 → peak
            return peak - peak * (1.0 - count / warmup)
        t = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_optimizer(params, tc: TrainConfig) -> torch.optim.AdamW:
    """optax's ``adamw`` over every parameter (biases, LayerNorms and
    embeddings included, as with no mask): betas (0.9, 0.999), eps 1e-8,
    decoupled weight decay; one fused update on the card.  Its learning
    rate is set before each update from :func:`lr_schedule`
    (:func:`make_train_step` does it)."""
    params = list(params)
    return torch.optim.AdamW(params, lr=lr_schedule(tc)(0), betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=tc.weight_decay,
                             fused=bool(params) and params[0].is_cuda)


def contrastive_loss(
    encode: Callable[[torch.Tensor], torch.Tensor],
    q_tokens: torch.Tensor,
    d_tokens: torch.Tensor,
    temperature: float,
    moe_aux_weight: float = 0.01,
    targets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE with in-batch negatives over
    ``logits = encode(q) @ encode(d).T / temperature`` (both batches in one
    ``encode`` call).

    ``targets`` (optional, ``[B, B]`` row-stochastic) replaces the identity
    labels with soft listwise targets (the distillation objective of
    ``models/pretrain.PairSampler``); the reverse (d → q) direction
    renormalises ``targets.T`` per row, so both directions distill the
    same teacher mass.  ``targets=None`` is the classic InfoNCE.  The MoE
    load-balance term (``moe_aux``) is 0: this encoder has no MoE blocks."""
    # one encode of both batches (padded to one length with -1, which
    # changes no embedding): half the launches of two
    L = max(q_tokens.shape[1], d_tokens.shape[1])
    both = torch.cat([F.pad(t, (0, L - t.shape[1]), value=-1)
                      for t in (q_tokens, d_tokens)])
    qe, de = encode(both).split([q_tokens.shape[0], d_tokens.shape[0]])
    logits = qe @ de.T / temperature                   # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    if targets is None:
        l_qd = F.cross_entropy(logits, labels)
        l_dq = F.cross_entropy(logits.T, labels)
    else:
        t_dq = targets.T / torch.clamp(targets.T.sum(dim=1, keepdim=True), min=1e-9)
        l_qd = F.cross_entropy(logits, targets)
        l_dq = F.cross_entropy(logits.T, t_dq)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    loss = (l_qd + l_dq) / 2 + moe_aux_weight * aux
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return loss, {"loss": loss.detach(), "accuracy": acc, "moe_aux": aux}


def make_train_step(module: Encoder, optimizer: torch.optim.Optimizer,
                    tc: TrainConfig):
    """The train step: ``step(q_tokens, d_tokens[, targets]) -> metrics``
    updates ``module``'s parameters in place (the gradients stay in each
    parameter's ``.grad`` until the next step) and returns ``loss``,
    ``accuracy`` and ``moe_aux`` as 0-d tensors on the device.  Token
    batches are ``[B, L]`` ids padded with -1, on any device; ``targets``
    the optional ``[B, B]`` soft listwise matrix."""
    schedule = lr_schedule(tc)
    updates = 0

    def step(q_tokens, d_tokens, targets=None) -> Dict[str, torch.Tensor]:
        nonlocal updates
        dev = next(module.parameters()).device
        q_tokens = q_tokens.to(dev, non_blocking=True)
        d_tokens = d_tokens.to(dev, non_blocking=True)
        if targets is not None:
            targets = targets.to(dev, non_blocking=True)
        module.train()
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = contrastive_loss(module, q_tokens, d_tokens, tc.temperature,
                                         tc.moe_aux_weight, targets)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = schedule(updates)
        optimizer.step()
        updates += 1
        return metrics

    return step


def init_training(
    cfg: EncoderConfig,
    tc: TrainConfig,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
):
    """Random encoder weights (drawn on the host from ``generator``, seed 0
    by default, so every device starts from the same weights), its AdamW
    and its train step, on ``device`` (the card unless the caller names
    another).  Returns ``(module, optimizer, step)``."""
    device = resolve_device(device)
    module = Encoder(cfg)
    module.init_weights(generator if generator is not None
                        else torch.Generator().manual_seed(0))
    module.to(device)
    optimizer = make_optimizer(module.parameters(), tc)
    return module, optimizer, make_train_step(module, optimizer, tc)
