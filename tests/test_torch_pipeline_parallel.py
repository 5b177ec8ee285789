"""The port's GPipe schedule (``parallel/pipeline.pipeline_forward``), the
pipelined encoder (``models/pipelined.py``), the ``data x pipe`` train
step and the multi-rank dry run (``parallel/dryrun.py``), in gloo worlds on
the CPU, against the JAX package on its 8-device CPU mesh and against the
plain, unpipelined computation.

Tolerances: a tanh-linear stage stack in f32 within 2e-4 relative / 2e-5
absolute of the sequential product (the reference's own test), and its
gradients within 1e-5 of autograd through the sequential stack; the
encoder's blocks through the schedule bitwise equal to the same blocks
applied in turn (the same operations on the same microbatches);
``encode_pipelined`` in f32 within 1e-5 of the plain forward and of the
reference's ``encode_pipelined``; the dp x pp step as the dense step of
``tests/test_torch_parallel_train.py``."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.models.encoder import Encoder as JaxEncoder
from rag_challenge_2_tpu.models.encoder import EncoderConfig as JaxCfg
from rag_challenge_2_tpu.models.pipelined import encode_pipelined as jax_encode_pipelined
from rag_challenge_2_tpu.models.train import TrainConfig as JaxTrainConfig
from rag_challenge_2_tpu.models.train import init_training as jax_init
from rag_challenge_2_tpu.parallel.mesh import make_mesh as jax_mesh
from rag_challenge_2_tpu.parallel.pipeline import pipeline_forward as jax_pipeline
from rag_challenge_2_tpu_torch.models.encoder import Encoder, EncoderConfig, from_jax_params
from rag_challenge_2_tpu_torch.parallel.launch import run_ranks
from tests import torch_train_ranks as R
from tests.test_torch_parallel_train import SURE, batch, flat, single_step

ROOT = Path(__file__).resolve().parents[1]


def _stack_params(rng, S, d):
    return {"w": (rng.normal(size=(S, d, d)) * 0.3).astype(np.float32),
            "b": (rng.normal(size=(S, d)) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("S,M", [(4, 6), (2, 1)])
def test_pipeline_matches_sequential(S, M):
    """The twin of the reference's test: M microbatches through S stages
    equal the stages applied in turn, and the reference's
    ``pipeline_forward``; the backward (each rotation sends its gradient
    back one stage) equals autograd through the sequential stack."""
    rng = np.random.default_rng(0)
    d, mb = 16, 4
    params = _stack_params(rng, S, d)
    xs = rng.normal(size=(M, mb, d)).astype(np.float32)
    out, grads, gx = run_ranks(R.pipeline_case, S, "gloo", "cpu",
                               (S, M, params, xs, "data"))
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    x = torch.from_numpy(xs).requires_grad_()
    h = x
    for s in range(S):
        h = torch.tanh(h @ p["w"][s] + p["b"][s])
    h.sum().backward()
    np.testing.assert_allclose(out, h.detach().numpy(), rtol=2e-4, atol=2e-5)
    jout = jax_pipeline(lambda pp, y: jnp.tanh(y @ pp["w"] + pp["b"]),
                        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xs),
                        jax_mesh({"pipe": S}), axis="pipe")
    np.testing.assert_allclose(out, np.asarray(jout), rtol=2e-4, atol=2e-5)
    for k in params:
        np.testing.assert_allclose(grads[k], p[k].grad.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gx, x.grad.numpy(), rtol=0, atol=1e-5)


def test_pipeline_data_axis_splits_each_microbatch():
    """``batch_axis``: a ``data 2 x pipe 2`` world splits each microbatch's
    rows over ``data`` and gathers them back; outputs and gradients as
    one device computes them."""
    rng = np.random.default_rng(1)
    params = _stack_params(rng, 2, 8)
    xs = rng.normal(size=(3, 4, 8)).astype(np.float32)
    out, grads, gx = run_ranks(R.pipeline_case, 4, "gloo", "cpu", (2, 3, params, xs, "data"))
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    x = torch.from_numpy(xs).requires_grad_()
    h = torch.tanh(torch.tanh(x @ p["w"][0] + p["b"][0]) @ p["w"][1] + p["b"][1])
    h.sum().backward()
    np.testing.assert_allclose(out, h.detach().numpy(), rtol=2e-4, atol=2e-5)
    for k in params:
        np.testing.assert_allclose(grads[k], p[k].grad.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gx, x.grad.numpy(), rtol=0, atol=1e-5)


def test_pipeline_with_encoder_blocks():
    """The encoder's homogeneous block stack (bf16 activations) runs
    through the schedule: bitwise the blocks applied in turn."""
    cfg = dict(vocab_bits=8, d_model=16, n_layers=4, n_heads=2, d_ff=32, max_len=8,
               out_dim=8)
    m = Encoder(EncoderConfig(**cfg))
    m.init_weights(torch.Generator().manual_seed(0))
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    xs = np.random.default_rng(42).normal(size=(2, 2, 8, 16)).astype(np.float32)
    got, want = run_ranks(R.pipelined_blocks, 4, "gloo", "cpu", (cfg, 4, 2, sd, xs))
    np.testing.assert_array_equal(got, want)


def test_encode_pipelined_matches_plain():
    """The twin of the reference's test on ``data 2 x pipe 4`` (8 ranks),
    f32 activations: the pipelined forward equals the plain ``Encoder``
    and the reference's ``encode_pipelined``; its asserts are the
    reference's."""
    cfg = dict(vocab_bits=10, d_model=32, n_layers=4, n_heads=4, d_ff=64, max_len=16,
               out_dim=16)
    jm = JaxEncoder(JaxCfg(**cfg, dtype=jnp.float32))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tokens = np.random.default_rng(0).integers(0, 1024, (8, 12)).astype(np.int32)
    tokens[3, 6:] = -1                                   # a padded row
    sd = {k: v.numpy() for k, v in from_jax_params(flat(params)).items()}
    cfg_t = dict(cfg, dtype=torch.float32)
    got, said = run_ranks(R.encode_pipelined_case, 8, "gloo", "cpu",
                          (cfg_t, {"data": 2, "pipe": 4}, 2, sd, tokens))
    plain = Encoder(EncoderConfig(**cfg_t))
    plain.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        want = plain(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jgot = jax_encode_pipelined(JaxCfg(**cfg, dtype=jnp.float32), params, jnp.asarray(tokens),
                                jax_mesh({"data": 2, "pipe": 4}), n_micro=2)
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=0, atol=1e-5)
    assert said[0] == "pipelined encoder requires homogeneous blocks"
    assert said[1] == "pipe axis (4) must equal n_layers (5) — one stage per block"
    assert said[2] == "batch 7 not divisible by 2 microbatches"


@pytest.mark.parametrize("grid,n_layers", [({"data": 2, "pipe": 2}, 2),
                                           ({"data": 1, "pipe": 4}, 4)],
                         ids=["dp2xpp2", "pp4"])
def test_train_step_dp_pp(grid, n_layers):
    """The twin of the reference's dp x pp step: one InfoNCE step through
    the GPipe forward (``pp_microbatches`` 2) equals the port's
    single-device step and the reference's pipelined step on the same mesh
    shape; every block's parameters move."""
    cfg = dict(vocab_bits=10, d_model=32, n_layers=n_layers, n_heads=4, d_ff=64,
               max_len=16, out_dim=16)
    tc_kw = dict(lr=1e-3, pp_microbatches=2)
    _, params, opt_state, jstep = jax_init(JaxCfg(**cfg, dtype=jnp.float32),
                                           JaxTrainConfig(**tc_kw), jax_mesh(grid), seed=1)
    sd = {k: v.numpy() for k, v in from_jax_params(flat(params)).items()}
    q, d = batch(1, B=8, L=12)
    jparams, _, jmet = jstep(params, opt_state, jnp.asarray(q), jnp.asarray(d))
    jafter = {k: v.numpy() for k, v in from_jax_params(flat(jparams)).items()}
    cfg_t = dict(cfg, dtype=torch.float32)
    r = run_ranks(R.sharded_step, 4, "gloo", "cpu", (cfg_t, tc_kw, grid, sd, q, d))
    metrics, grads, after = single_step(cfg_t, tc_kw, sd, q, d)
    assert all(e == r["every"][0] for e in r["every"])
    np.testing.assert_allclose(r["metrics"][0]["loss"], metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(r["metrics"][0]["loss"], float(jmet["loss"]), rtol=1e-5)
    top = max(np.abs(g).max() for g in grads.values())
    for name, g in grads.items():
        if name.endswith(".key.bias"):
            assert np.abs(r["grads"][name]).max() <= 1e-4 * top
            continue
        np.testing.assert_allclose(r["grads"][name], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)
        sure = np.abs(g) >= SURE * np.abs(g).max()
        for ref in (after, jafter):
            np.testing.assert_allclose(r["after"][name][sure], ref[name][sure], rtol=0,
                                       atol=1e-6, err_msg=name)
    for i in range(n_layers):
        key = f"blocks.{i}.mlp_in.weight"
        assert not np.allclose(r["after"][key], sd[key])


def test_dryrun_at_four_ranks():
    """``python -m rag_challenge_2_tpu_torch.parallel.dryrun 4 --device
    cpu`` passes every check (dp x tp x sp dense and MoE, dp x pp, the
    sharded top-k, the sharded IVF at nprobe = K, the two-level merge and
    the sharded engines, hybrid_expansion among them) and prints one
    summary line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "rag_challenge_2_tpu_torch.parallel.dryrun", "4",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("dryrun OK: 4 ranks (gloo, cpu)")
    for part in ("mesh data=2 model=2", "hierarchical merge parity: OK",
                 "hybrid dense+bm25+fusion sharded parity: OK"):
        assert part in lines[0], lines[0]
    # the traversal-inclusive graph over the row-sharded store
    assert int(lines[0].split(" rows + hybrid_expansion ")[1].split(" rows")[0]) > 0
    losses = [float(lines[0].split(f"{k} loss=")[1].split(",")[0])
              for k in ("dense", "moe", "pp")]
    assert np.isfinite(losses).all(), losses
