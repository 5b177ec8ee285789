"""The port's parallel train step (``models/train.py`` on a mesh,
``parallel/mesh.{encoder_param_spec,shard_params}``,
``parallel/collectives.py``) in gloo worlds of 4 ranks on the CPU, against
the JAX package's sharded step on its 8-device CPU mesh and against the
port's own single-device step on the global batch, from the same
flax-initialised weights (carried over by ``from_jax_params``).

Tolerances, f32 activations (the experts of a MoE encoder are bf16 in
both packages): the sharded step's loss within 1e-5 relative of the
single device's, every gradient within 1e-4 of its tensor's largest
element (the collectives sum in another order), and the parameters after
the step within 1e-6 wherever the gradient's sign is sure (|g| >= 1e-3 of
its tensor's largest; Adam's first update is about ``lr * sign(g)``).
Against JAX: the dense loss within 1e-5 relative and the sure-signed
parameters within 1e-6; the MoE loss within 1e-3 relative after the
stale load-balance value the reference carries (``contrastive_loss``'s
departure: twice its sum, times ``moe_aux_weight``), and at most 0.5% of
the sure-signed parameters further than 1e-6 (bf16 experts round
elsewhere).  The MoE encoder's gradients against the single device's:
a per-tensor cosine of at least 0.9999 (a bf16 expert's backward rounds a
gradient that differs in its last f32 bits) and a per-tensor norm within
1e-3 of the single device's (the cosine does not see a scale), and the
same 0.5% allowance for the parameters.  Attention's key bias has a gradient of 0 in exact arithmetic
and is held under 1e-4 of the model's largest gradient on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.models.encoder import Encoder as JaxEncoder
from rag_challenge_2_tpu.models.encoder import EncoderConfig as JaxCfg
from rag_challenge_2_tpu.models.train import TrainConfig as JaxTrainConfig
from rag_challenge_2_tpu.models.train import init_training as jax_init
from rag_challenge_2_tpu.parallel.mesh import encoder_param_spec as jax_spec
from rag_challenge_2_tpu.parallel.mesh import make_mesh as jax_mesh
from rag_challenge_2_tpu_torch.models.encoder import (
    Encoder, EncoderConfig, from_jax_params, to_jax_params)
from rag_challenge_2_tpu_torch.models.train import (
    TrainConfig, make_optimizer, make_train_step)
from rag_challenge_2_tpu_torch.parallel import encoder_param_spec
from rag_challenge_2_tpu_torch.parallel.launch import run_ranks
from tests import torch_train_ranks as R

SMALL = dict(vocab_bits=10, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_len=32, out_dim=16)
GRID = {"data": 2, "model": 2}
SURE = 1e-3


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def batch(seed=0, B=8, L=16):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 1 << SMALL["vocab_bits"], (B, L)).astype(np.int32)
    d = rng.integers(0, 1 << SMALL["vocab_bits"], (B, L)).astype(np.int32)
    q[3, L // 2:] = -1
    return q, d


def single_step(cfg_kw, tc_kw, sd, q, d):
    """The port's single-device step on the global batch."""
    tc = TrainConfig(**tc_kw)
    m = Encoder(EncoderConfig(**cfg_kw))
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    step = make_train_step(m, make_optimizer(m.parameters(), tc), tc)
    metrics = {k: v.item() for k, v in step(torch.from_numpy(q), torch.from_numpy(d)).items()}
    return (metrics, {n: p.grad.numpy() for n, p in m.named_parameters()},
            {n: p.detach().numpy() for n, p in m.named_parameters()})


def _ownership(shape, spec, tp):
    """Which of ``tp`` model shards holds each element (-1: replicated)."""
    own = np.full(shape, -1.0, np.float32)
    for dim, axis in enumerate(spec):
        if axis == "model":
            idx = np.arange(shape[dim]) // (shape[dim] // tp)
            own = np.broadcast_to(idx.reshape([-1 if i == dim else 1
                                               for i in range(len(shape))]),
                                  shape).astype(np.float32)
    return own


@pytest.mark.parametrize("moe", [0, 4])
def test_encoder_param_spec_matches_reference(moe):
    """Every parameter of the port is split over ``model`` exactly where
    the reference's flax leaf is: each element's owning shard (2 shards),
    carried to the flax layout by ``to_jax_params``, equals the one the
    reference's ``encoder_param_spec`` gives (the twin of
    ``test_param_sharding_specs_cover_all_params``)."""
    cfg = dict(SMALL, moe_experts=moe)
    params = JaxEncoder(JaxCfg(**cfg)).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        spec = tuple(jax_spec(path, leaf))
        assert len([s for s in spec if s is not None]) <= leaf.ndim
        want[key] = _ownership(leaf.shape, spec, 2)
    tm = Encoder(EncoderConfig(**cfg))
    specs = {n: encoder_param_spec(n, p) for n, p in tm.named_parameters()}
    assert all(len(s) <= p.dim() for s, p in zip(specs.values(), tm.parameters()))
    assert {a for s in specs.values() for a in s} <= {None, "model"}
    own = {n: torch.from_numpy(_ownership(tuple(p.shape), specs[n], 2))
           for n, p in tm.named_parameters()}
    got = to_jax_params(own, SMALL["n_heads"])
    assert set(got) == set(want)
    for key in want:
        if key.startswith("params/"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got["params/tok_embed/embedding"] >= 0).all()     # the feature split
    if moe:
        assert (got["params/block1/moe/w_in"][2:] == 1).all()


def _compare_with_single(r, single, moe):
    """The sharded step (every rank) against the single device's."""
    metrics, grads, after = single
    for every in r["every"]:
        assert every == r["every"][0]                 # the same metrics on every rank
    got = r["metrics"][0]
    np.testing.assert_allclose(got["loss"], metrics["loss"], rtol=1e-5)
    assert got["accuracy"] == metrics["accuracy"]
    np.testing.assert_allclose(got["moe_aux"], metrics["moe_aux"], rtol=1e-5)
    top = max(np.abs(g).max() for g in grads.values())
    off = compared = 0
    for name, g in grads.items():
        gg = r["grads"][name]
        if name.endswith(".key.bias"):
            assert np.abs(gg).max() <= 1e-4 * top and np.abs(g).max() <= 1e-4 * top
            continue
        if moe:
            a, b = gg.ravel().astype(np.float64), g.ravel().astype(np.float64)
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            assert a @ b >= 0.9999 * na * nb, name
            # the cosine cannot see a scale: a gradient counted once a rank
            # (or 1/W of it) is caught by its norm
            assert abs(na / nb - 1) <= 1e-3 if nb > 0 else na == 0, (name, na, nb)
        else:
            np.testing.assert_allclose(gg, g, rtol=0, atol=1e-4 * np.abs(g).max(),
                                       err_msg=name)
        sure = np.abs(g) >= SURE * np.abs(g).max()
        off += int((np.abs(r["after"][name] - after[name])[sure] > 1e-6).sum())
        compared += int(sure.sum())
    assert off <= (5e-3 * compared if moe else 0), (off, compared)


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_data2_model2_step_matches_jax_and_single_device(moe, sp):
    """The twins of ``tests/test_models.py``'s sharded, sequence-parallel
    and MoE (expert-parallel) train steps: one step of ``data 2 x model 2``
    equals the JAX package's sharded step and the port's single-device
    step on the global batch."""
    cfg = dict(SMALL, moe_experts=moe)
    tc_kw = dict(lr=1e-3, sequence_parallel=sp)
    mesh = jax_mesh(GRID)
    _, params, opt_state, jstep = jax_init(JaxCfg(**cfg, dtype=jnp.float32),
                                           JaxTrainConfig(**tc_kw), mesh, seed=1)
    jflat = flat(params)
    sd = {k: v.numpy() for k, v in from_jax_params(jflat).items()}
    q, d = batch()
    jparams, _, jmet = jstep(params, opt_state, jnp.asarray(q), jnp.asarray(d))
    jafter = {k: v.numpy() for k, v in from_jax_params(flat(jparams)).items()}
    cfg_t = dict(cfg, dtype=torch.float32)
    r = run_ranks(R.sharded_step, 4, "gloo", "cpu", (cfg_t, tc_kw, GRID, sd, q, d))
    single = single_step(cfg_t, tc_kw, sd, q, d)
    _compare_with_single(r, single, moe)

    # split as the reference splits: heads, hidden features, experts, tables
    shapes = r["shapes"][0]
    assert shapes["blocks.0.query.weight"] == (SMALL["d_model"] // 2, SMALL["d_model"])
    assert shapes["tok_embed"] == (1 << SMALL["vocab_bits"], SMALL["d_model"] // 2)
    if moe:
        assert shapes["blocks.1.moe.w_in"][0] == 2 and shapes["blocks.1.moe.router.weight"][0] == 4
    stale = sum(float(v) for k, v in jflat.items() if k.startswith("losses/"))
    assert (stale > 0) == bool(moe)
    np.testing.assert_allclose(r["metrics"][0]["loss"],
                               float(jmet["loss"]) - 0.01 * 2 * stale,
                               rtol=1e-3 if moe else 1e-5)
    np.testing.assert_allclose(r["metrics"][0]["moe_aux"],
                               float(jmet["moe_aux"]) - 2 * stale, rtol=1e-5, atol=1e-6)
    grads = single[1]
    off = compared = 0
    for name, g in grads.items():
        if name.endswith(".key.bias"):
            continue
        sure = np.abs(g) >= SURE * np.abs(g).max()
        off += int((np.abs(r["after"][name] - jafter[name])[sure] > 1e-6).sum())
        compared += int(sure.sum())
    assert off <= (5e-3 * compared if moe else 0), (off, compared)


def test_init_training_on_a_mesh_starts_from_the_single_device_weights():
    """``init_training(mesh=...)`` draws the whole weights on the host from
    the generator and keeps each rank's shard: gathered back, they are the
    single device's draw, bitwise; a step's metrics agree on every rank and
    the loss falls over two steps of matched pairs."""
    cfg = dict(SMALL, moe_experts=4)
    r = run_ranks(R.init_world, 4, "gloo", "cpu",
                  (cfg, dict(lr=1e-2, sequence_parallel=True), GRID, 3))
    m = Encoder(EncoderConfig(**cfg))
    m.init_weights(torch.Generator().manual_seed(3))
    for n, p in m.named_parameters():
        np.testing.assert_array_equal(r["weights"][n], p.detach().numpy(), err_msg=n)
    assert all(e == r["every"][0] for e in r["every"])
    assert np.isfinite(r["every"][0]["loss"])


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_moe_routes_over_the_global_batch(sp):
    """On ``data 2 x model 2`` each rank routes its own tokens, but the
    queues, the capacity and the load-balance means are the global batch's:
    the embeddings and the load-balance term equal one device's forward on
    the whole batch, and differ from routing each data shard alone (the
    capacity binds at this batch)."""
    cfg = dict(SMALL, moe_experts=4, dtype=torch.float32)
    m = Encoder(EncoderConfig(**cfg))
    m.init_weights(torch.Generator().manual_seed(2))
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    ids, _ = batch(5)
    e, aux = run_ranks(R.moe_forward, 4, "gloo", "cpu", (cfg, GRID, sp, sd, ids))
    with torch.no_grad():
        want, want_aux = m(torch.from_numpy(ids), return_aux=True)
        halves = torch.cat([m(torch.from_numpy(h)) for h in np.split(ids, 2)])
    np.testing.assert_allclose(e, want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(aux, want_aux.item(), rtol=1e-6)
    assert np.abs(halves.numpy() - want.numpy()).max() > 1e-3


def test_shard_params_raises_where_an_axis_does_not_divide():
    """GSPMD pads a dimension its axis does not divide; the port raises,
    naming the parameter (6 heads over 4 model shards)."""
    cfg = dict(SMALL, d_model=48, n_heads=6, d_ff=96)
    msg = run_ranks(R.shard_errors, 4, "gloo", "cpu", (cfg, {"model": 4}))
    assert msg is not None and "tok_embed" not in msg and "query.weight" in msg, msg
