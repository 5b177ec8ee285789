"""Contrastive training for the embedding encoder, on one device or on a
mesh.

Port of ``rag_challenge_2_tpu/models/train.py``: symmetric InfoNCE over
(query, passage) pairs with in-batch negatives (the ``q @ d.T`` logits),
optionally with soft listwise targets, plus the MoE load-balance term,
and AdamW over every parameter with the reference's learning-rate
schedule.

On a mesh (``parallel/mesh.make_mesh`` on the ranks of a
``parallel/launch.run_ranks`` world) the step is the single-device step on
the global batch, which every rank is given whole:

* ``data`` splits the batch's rows; the embeddings are all-gathered, so
  the logits span the global batch (in-batch negatives across ranks);
* ``model`` is Megatron tensor parallelism (``parallel/mesh.shard_params``):
  the output projections all-reduce, the feature-split embedding tables
  all-gather, and ``TrainConfig.sequence_parallel`` splits the sequence
  over ``model`` between blocks (all-gather before attention and the MLP,
  reduce-scatter after); MoE experts split over ``model`` and route over
  the global batch (``models/moe.py``);
* ``pipe`` runs the block stack as a GPipe pipeline of
  ``TrainConfig.pp_microbatches`` microbatches (``models/pipelined.py``),
  with the batch split over ``data``.

Every collective is differentiable (``parallel/collectives.py``); each
rank back-propagates ``loss / ranks`` and then sums every gradient over
the axes its parameter is replicated over, so each counts once.

A step launches its work and returns its metrics as 0-d tensors on the
device: nothing in it waits for the device (but a mesh's collectives), so
the host can prepare the next batch while the device runs this one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..parallel.collectives import ShardPlan, gather, sum_grads
from ..parallel.mesh import encoder_param_spec, shard_params
from .encoder import Encoder, EncoderConfig
from .pipelined import encode_pipelined


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
    encode: Callable,
    q_tokens: torch.Tensor,
    d_tokens: torch.Tensor,
    temperature: float,
    moe_aux_weight: float = 0.01,
    targets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE with in-batch negatives over
    ``logits = encode(q) @ encode(d).T / temperature``, plus
    ``moe_aux_weight`` times the MoE load-balance term of these forwards.

    ``encode(tokens, return_aux=True) -> (embeddings, aux)`` is an
    :class:`~.encoder.Encoder` or a mesh's global-batch encoder, with a
    ``cfg``.  A dense encoder embeds both batches in one call (padded to
    one length with -1, which changes no embedding: half the launches of
    two).  With MoE blocks q and d are two calls, as in the reference:
    each routes its own tokens, and padding tokens are routed like any.

    ``targets`` (optional, ``[B, B]`` row-stochastic) replaces the identity
    labels with soft listwise targets (the distillation objective of
    ``models/pretrain.PairSampler``); the reverse (d → q) direction
    renormalises ``targets.T`` per row, so both directions distill the
    same teacher mass.  ``targets=None`` is the classic InfoNCE.

    A departure by design: the reference initialises its params with the
    whole ``Encoder.init`` tree, so its ``losses`` collection (the
    load-balance values sown at init) rides along as if it were a
    parameter, and each forward's ``apply(mutable=["losses"])`` appends
    to it.  Its ``moe_aux`` then carries that stale constant once per
    forward (twice a step), and AdamW moves it.  Here ``moe_aux`` holds
    only this step's two forwards: it equals the reference's minus twice
    that constant, the loss the reference's minus ``moe_aux_weight`` times
    twice it, and every gradient of a real parameter is the same (the
    constant depends on none)."""
    if encode.cfg.moe_experts > 0:
        qe, qa = encode(q_tokens, return_aux=True)
        de, da = encode(d_tokens, return_aux=True)
        aux = qa + da
    else:
        L = max(q_tokens.shape[1], d_tokens.shape[1])
        both = torch.cat([F.pad(t, (0, L - t.shape[1]), value=-1)
                          for t in (q_tokens, d_tokens)])
        e, aux = encode(both, return_aux=True)
        qe, de = e.split([q_tokens.shape[0], d_tokens.shape[0]])
    logits = qe @ de.T / temperature                   # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    if targets is None:
        l_qd = F.cross_entropy(logits, labels)
        l_dq = F.cross_entropy(logits.T, labels)
    else:
        t_dq = targets.T / torch.clamp(targets.T.sum(dim=1, keepdim=True), min=1e-9)
        l_qd = F.cross_entropy(logits, targets)
        l_dq = F.cross_entropy(logits.T, t_dq)
    loss = (l_qd + l_dq) / 2 + moe_aux_weight * aux
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return loss, {"loss": loss.detach(), "accuracy": acc, "moe_aux": aux.detach()}


class GlobalBatch:
    """The encoder of a ``data``-split mesh as a function of the global
    batch: this rank's rows through ``module`` (its shard), then every
    rank's embeddings all-gathered (differentiable), so every rank holds
    the global ``[B, out_dim]``.  The batch's rows must divide over
    ``data``."""

    def __init__(self, module: Encoder, mesh):
        self.module, self.cfg = module, module.cfg
        self.plan = ShardPlan.of(mesh, False)

    def __call__(self, tokens: torch.Tensor, return_aux: bool = False):
        dp, d = self.plan.dp, self.plan.d
        if tokens.shape[0] % dp:
            raise ValueError(f"a batch of {tokens.shape[0]} rows does not divide "
                             f"over {dp} data shards")
        n = tokens.shape[0] // dp
        e, aux = self.module(tokens[d * n:(d + 1) * n], return_aux=True)
        e = gather(e, self.plan.data, 0)
        return (e, aux) if return_aux else e


class Pipelined:
    """The encoder of a ``pipe`` mesh (``models/pipelined.encode_pipelined``)
    as a function of the global batch; it has no MoE blocks, so its
    load-balance term is 0."""

    def __init__(self, module: Encoder, mesh, n_micro: int):
        self.module, self.cfg, self.mesh, self.n_micro = module, module.cfg, mesh, n_micro

    def __call__(self, tokens: torch.Tensor, return_aux: bool = False):
        e = encode_pipelined(self.cfg, self.module, tokens, self.mesh, self.n_micro)
        return (e, torch.zeros((), device=e.device)) if return_aux else e


def make_train_step(module: Encoder, optimizer: torch.optim.Optimizer,
                    tc: TrainConfig, mesh=None):
    """The train step: ``step(q_tokens, d_tokens[, targets]) -> metrics``
    updates ``module``'s parameters in place (the gradients stay in each
    parameter's ``.grad`` until the next step) and returns ``loss``,
    ``accuracy`` and ``moe_aux`` as 0-d tensors on the device.  Token
    batches are ``[B, L]`` ids padded with -1, on any device; ``targets``
    the optional ``[B, B]`` soft listwise matrix.

    With ``mesh`` (every rank calls the step with the same global batch)
    ``module`` is this rank's shard (``parallel/mesh.shard_params``), and
    the metrics are the global batch's, the same on every rank."""
    schedule = lr_schedule(tc)
    updates = 0
    if mesh is None:
        encode, ranks = module, 1
    elif "pipe" in mesh.mesh_dim_names:
        encode, ranks = Pipelined(module, mesh, tc.pp_microbatches), mesh.size()
    else:
        encode, ranks = GlobalBatch(module, mesh), mesh.size()

    def step(q_tokens, d_tokens, targets=None) -> Dict[str, torch.Tensor]:
        nonlocal updates
        dev = next(module.parameters()).device
        q_tokens = q_tokens.to(dev, non_blocking=True)
        d_tokens = d_tokens.to(dev, non_blocking=True)
        if targets is not None:
            targets = targets.to(dev, non_blocking=True)
        module.train()
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = contrastive_loss(encode, q_tokens, d_tokens, tc.temperature,
                                         tc.moe_aux_weight, targets)
        (loss / ranks).backward()
        if mesh is not None:
            sum_grads(module.named_parameters(), mesh, encoder_param_spec)
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
    mesh=None,
):
    """Random encoder weights (drawn in full on the host from
    ``generator``, seed 0 by default, so every device and every world
    starts from the same weights), its AdamW and its train step, on
    ``device`` (the card unless the caller names another).  With ``mesh``
    (called on every rank of a world) each rank keeps its shard of the
    weights and the step is the mesh's (:func:`make_train_step`); a mesh
    with a ``pipe`` axis runs the block stack through the GPipe schedule.
    Returns ``(module, optimizer, step)``."""
    device = resolve_device(device)
    module = Encoder(cfg, sequence_parallel=tc.sequence_parallel)
    module.init_weights(generator if generator is not None
                        else torch.Generator().manual_seed(0))
    if mesh is not None:
        shard_params(module, mesh)
    module.to(device)
    optimizer = make_optimizer(module.parameters(), tc)
    return module, optimizer, make_train_step(module, optimizer, tc, mesh)
