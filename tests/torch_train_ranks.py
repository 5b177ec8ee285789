"""Rank programs of the port's parallel training tests.

Each function runs on every rank of a gloo world on the CPU that a test
starts with ``rag_challenge_2_tpu_torch.parallel.launch.run_ranks``; rank
0's return value comes back to the test.  A rank is a fresh interpreter
that imports this module, so it imports torch and the port only, never
JAX (the tests compare what comes back with the JAX package in the
parent).  Weights arrive as a numpy state dict, batches as numpy arrays,
and results leave as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _mesh(axes):
    from rag_challenge_2_tpu_torch.parallel import make_mesh

    return make_mesh(dict(axes), "gloo", "cpu")


def sharded_step(dev, cfg_kw, tc_kw, axes, sd, q, d, steps=1):
    """``steps`` train steps of the port on the mesh ``axes`` from the
    weights ``sd``, every rank given the global batch: each step's
    metrics, the whole gradients of the last step and the whole
    parameters after it (gathered from the shards), and each rank's own
    shapes (so the test sees that the weights were split)."""
    from rag_challenge_2_tpu_torch.models.encoder import Encoder, EncoderConfig
    from rag_challenge_2_tpu_torch.models.train import (
        TrainConfig, make_optimizer, make_train_step)
    from rag_challenge_2_tpu_torch.parallel.mesh import shard_params, whole_param

    mesh = _mesh(axes)
    tc = TrainConfig(**tc_kw)
    module = Encoder(EncoderConfig(**cfg_kw), sequence_parallel=tc.sequence_parallel)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    shard_params(module, mesh)
    module.to(dev)
    step = make_train_step(module, make_optimizer(module.parameters(), tc), tc, mesh)
    metrics = [{k: v.item() for k, v in step(torch.from_numpy(q), torch.from_numpy(d)).items()}
               for _ in range(steps)]
    grads = {n: whole_param(n, p.grad, mesh).numpy() for n, p in module.named_parameters()}
    after = {n: whole_param(n, p.detach(), mesh).numpy() for n, p in module.named_parameters()}
    shapes = [None] * dist.get_world_size()
    dist.all_gather_object(shapes, {n: tuple(p.shape) for n, p in module.named_parameters()})
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, metrics)
    return dict(metrics=metrics, every=every, grads=grads, after=after, shapes=shapes)


def init_world(dev, cfg_kw, tc_kw, axes, seed):
    """``init_training`` on the mesh ``axes``: the whole weights it drew
    (gathered from the shards) and one step's metrics on every rank."""
    from rag_challenge_2_tpu_torch.models.encoder import EncoderConfig
    from rag_challenge_2_tpu_torch.models.train import TrainConfig, init_training
    from rag_challenge_2_tpu_torch.parallel.mesh import whole_param

    mesh = _mesh(axes)
    module, _, step = init_training(EncoderConfig(**cfg_kw), TrainConfig(**tc_kw), dev,
                                    torch.Generator().manual_seed(seed), mesh)
    weights = {n: whole_param(n, p.detach().clone(), mesh).numpy()
               for n, p in module.named_parameters()}
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 1 << cfg_kw["vocab_bits"], (8, 16)).astype(np.int32))
    m = {k: v.item() for k, v in step(q, q).items()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, m)
    return dict(weights=weights, every=every)


def moe_forward(dev, cfg_kw, axes, sp, sd, tokens):
    """The MoE encoder's forward (embeddings and load-balance term) on the
    mesh ``axes``, this rank's rows of ``tokens`` through its shard, then
    gathered: the global batch's, as one device computes it."""
    from rag_challenge_2_tpu_torch.models.encoder import Encoder, EncoderConfig
    from rag_challenge_2_tpu_torch.models.train import GlobalBatch
    from rag_challenge_2_tpu_torch.parallel.mesh import shard_params

    mesh = _mesh(axes)
    module = Encoder(EncoderConfig(**cfg_kw), sequence_parallel=sp)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    shard_params(module, mesh)
    with torch.no_grad():
        e, aux = GlobalBatch(module, mesh)(torch.from_numpy(tokens), return_aux=True)
    return e.numpy(), aux.item()


def pipeline_case(dev, S, M, params, xs, batch_axis):
    """``pipeline_forward`` of a tanh-linear stage over S stages (and a
    ``data`` axis when the world is larger), with the gradient of
    ``out.sum()`` with respect to each stage's parameters (summed over
    the data shards) and to the input."""
    from rag_challenge_2_tpu_torch.parallel import pipeline_forward
    from rag_challenge_2_tpu_torch.parallel.collectives import all_sum

    world = dist.get_world_size()
    axes = {"pipe": S} if world == S else {"data": world // S, "pipe": S}
    mesh = _mesh(axes)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    x = torch.from_numpy(xs).requires_grad_()

    def stage(pp, h):
        return torch.tanh(h @ pp["w"] + pp["b"])

    out = pipeline_forward(stage, p, x, mesh, "pipe",
                           batch_axis=batch_axis if "data" in axes else None)
    (out.sum() / world).backward()
    grads = {}
    for k, v in p.items():
        g = v.grad
        for a in axes:
            g = all_sum(g, mesh.get_group(a))
        grads[k] = g.numpy()
    gx = x.grad if x.grad is not None else torch.zeros_like(x)   # only stage 0 reads x
    for a in axes:
        gx = all_sum(gx, mesh.get_group(a))
    return out.detach().numpy(), grads, gx.numpy()


def encode_pipelined_case(dev, cfg_kw, axes, n_micro, sd, tokens):
    """``encode_pipelined`` on the mesh ``axes`` from the weights ``sd``,
    and what its asserts say to a MoE config, a pipe size other than the
    layer count and a batch that ``n_micro`` does not divide."""
    import dataclasses

    from rag_challenge_2_tpu_torch.models.encoder import Encoder, EncoderConfig
    from rag_challenge_2_tpu_torch.models.pipelined import encode_pipelined

    mesh = _mesh(axes)
    cfg = EncoderConfig(**cfg_kw)
    module = Encoder(cfg)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        out = encode_pipelined(cfg, module, t, mesh, n_micro).numpy()
    said = []
    for bad_cfg, bad_t in ((dataclasses.replace(cfg, moe_experts=4), t),
                           (dataclasses.replace(cfg, n_layers=cfg.n_layers + 1), t),
                           (cfg, t[:-1])):
        try:
            encode_pipelined(bad_cfg, module, bad_t, mesh, n_micro)
            said.append(None)
        except AssertionError as e:
            said.append(str(e))
    return out, said


def pipelined_blocks(dev, cfg_kw, S, M, sd, xs):
    """The encoder's block stack (one block a stage) through
    ``pipeline_forward`` with ``functional_call`` as the stage, and the
    same blocks applied in turn to each microbatch."""
    from torch.func import functional_call

    from rag_challenge_2_tpu_torch.models.encoder import Encoder, EncoderConfig
    from rag_challenge_2_tpu_torch.models.pipelined import stack_block_params
    from rag_challenge_2_tpu_torch.parallel import pipeline_forward

    mesh = _mesh({"pipe": S})
    module = Encoder(EncoderConfig(**cfg_kw))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = torch.from_numpy(xs)
    mask = torch.ones(x.shape[1], 1, x.shape[2], x.shape[2], dtype=torch.bool)
    with torch.no_grad():
        got = pipeline_forward(
            lambda pb, h: functional_call(module.blocks[0], pb, (h, mask))[0],
            stack_block_params(module, S), x, mesh)
        want = x
        for blk in module.blocks:
            want = torch.stack([blk(want[m], mask)[0] for m in range(M)])
    return got.float().numpy(), want.float().numpy()


def shard_errors(dev, cfg_kw, axes):
    """What ``shard_params`` raises for a dimension its axis does not divide."""
    from rag_challenge_2_tpu_torch.models.encoder import Encoder, EncoderConfig
    from rag_challenge_2_tpu_torch.parallel.mesh import shard_params

    try:
        shard_params(Encoder(EncoderConfig(**cfg_kw)), _mesh(axes))
    except ValueError as e:
        return str(e)
    return None


def pretrain_world(dev, texts, axes, kw):
    """``pretrain_encoder`` on the mesh ``axes`` (``kw``: its keywords,
    weights as numpy arrays): rank 0's whole weights and history, and from
    every rank its history, a digest of the whole weights it returned,
    whether those equal its trained shards gathered and its shards their
    split, its shards' shapes, the samplers it built (with the teacher
    each uses) and its calls of the device teacher (``bm25_scores``)."""
    import hashlib

    import rag_challenge_2_tpu_torch.models.pretrain as P
    from rag_challenge_2_tpu_torch.parallel.mesh import shard_state_dict, whole_param

    mesh = _mesh(axes)
    kw = dict(kw)
    if kw.get("init_params") is not None:
        kw["init_params"] = {k: torch.from_numpy(v) for k, v in kw["init_params"].items()}
    trained, samplers, teacher_calls = [], [], []
    real = P.init_training, P.PairSampler, P.bm25_scores

    def init(*a, **k):
        out = real[0](*a, **k)
        trained.append(out[0])
        return out

    class Sampler(real[1]):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            samplers.append(self)

    def teacher(*a, **k):
        teacher_calls.append(1)
        return real[2](*a, **k)

    P.init_training, P.PairSampler, P.bm25_scores = init, Sampler, teacher
    try:
        model, info = P.pretrain_encoder(texts, device=dev, mesh=mesh, **kw)
    finally:
        P.init_training, P.PairSampler, P.bm25_scores = real
    whole = model.module.state_dict()
    shards = {n: p.detach() for n, p in trained[0].named_parameters()}
    # collectives: every rank gathers every tensor, so no short cut
    gathered = [torch.equal(whole_param(n, shards[n], mesh), whole[n]) for n in whole]
    split = shard_state_dict(whole, mesh, kw["enc_cfg"].n_heads)
    digest = hashlib.sha256()
    for n, t in whole.items():
        digest.update(n.encode())
        digest.update(t.numpy().tobytes())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, dict(
        history=info["history"], digest=digest.hexdigest(), gathered=all(gathered),
        split=all(torch.equal(split[n], shards[n]) for n in whole),
        shapes={n: tuple(t.shape) for n, t in shards.items()},
        samplers=[(s._host_scorer is None, s._sparse.indptr.device.type) for s in samplers],
        teacher_calls=len(teacher_calls)))
    return dict(every=every, info=info, whole={n: t.numpy() for n, t in whole.items()})
