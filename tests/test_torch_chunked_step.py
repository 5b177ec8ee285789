"""The port's chunked train step (``models/train.make_chunked_train_step``,
``step.chunked``) and ``pretrain_encoder``'s chunks, held on the CPU
against the JAX package's ``make_chunked_train_step`` (a ``lax.scan`` of K
steps) and against K of the port's own single steps.

On the CPU the chunked step is its plain version, K eager steps on slices
of the chunk (the card replays a CUDA graph instead: ``chip_smoke.py``
phase 13a and ``tests/test_torch_train_card.py``).  Tolerances: against
JAX, K = 3 steps from the same flax-initialised weights in f32
activations, each step's loss within 1e-5 relative (the single step's
bound in ``tests/test_torch_train.py``) and its accuracy equal; against
the port's single steps, metrics and every parameter bitwise, for a dense
and a MoE encoder.  ``pretrain_encoder(steps=7, steps_per_dispatch=3)``
against the JAX package's (which scans each full chunk): the loss within
2e-3 relative, the accuracy within one example of 8, as
``tests/test_torch_pretrain.py`` holds the single-step loop."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rag_challenge_2_tpu.models.pretrain as JP
import rag_challenge_2_tpu_torch.models.pretrain as TP
from rag_challenge_2_tpu.models.encoder import EmbeddingModel as JaxModel
from rag_challenge_2_tpu.models.encoder import EncoderConfig as JaxCfg
from rag_challenge_2_tpu.models.train import TrainConfig as JaxTrainConfig
from rag_challenge_2_tpu.models.train import init_training as jax_init
from rag_challenge_2_tpu.parallel.mesh import make_mesh as jax_mesh
from rag_challenge_2_tpu_torch.models.encoder import EncoderConfig, from_jax_params
from rag_challenge_2_tpu_torch.models.moe import _counts
from rag_challenge_2_tpu_torch.models.train import TrainConfig, init_training
from tests.test_torch_pretrain import CORPUS

SMALL = dict(vocab_bits=10, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_len=32, out_dim=16)
K, B, L = 3, 8, 16


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def chunk(seed=0, targets=False):
    """``K`` batches of ``[B, L]`` tokens (some rows padded with -1) and,
    with ``targets``, ``K`` row-stochastic ``[B, B]`` listwise targets."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 1 << SMALL["vocab_bits"], (K, B, L)).astype(np.int32)
    d = rng.integers(0, 1 << SMALL["vocab_bits"], (K, B, L)).astype(np.int32)
    q[:, 2, L // 2:] = -1
    d[:, 5, L // 3:] = -1
    if not targets:
        return q, d, None
    p = rng.random((K, B, B)).astype(np.float32)
    p /= p.sum(2, keepdims=True)
    return q, d, (0.4 * np.eye(B, dtype=np.float32) + 0.6 * p).astype(np.float32)


@pytest.mark.parametrize("targets", [False, True], ids=["infonce", "listwise"])
def test_chunked_step_matches_jax_chunked(targets):
    q, d, t = chunk(1, targets)
    _, jparams, jstate, jstep = jax_init(JaxCfg(**SMALL, dtype=jnp.float32),
                                         JaxTrainConfig(lr=1e-3),
                                         jax_mesh({"data": 1, "model": 1}), seed=1)
    args = [jnp.asarray(q), jnp.asarray(d)] + ([] if t is None else [jnp.asarray(t)])
    sd = from_jax_params(flat(jparams))
    _, _, jm = jstep.chunked(jparams, jstate, *args)
    module, _, step = init_training(EncoderConfig(**SMALL, dtype=torch.float32),
                                    TrainConfig(lr=1e-3), "cpu")
    module.load_state_dict(sd)
    tm = step.chunked(torch.from_numpy(q), torch.from_numpy(d),
                      None if t is None else torch.from_numpy(t))
    assert set(tm) == {"loss", "accuracy", "moe_aux"}
    assert all(v.shape == (K,) for v in tm.values())
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(tm["accuracy"].numpy(), np.asarray(jm["accuracy"]))


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
def test_chunked_step_equals_single_steps_bitwise(moe):
    q, d, t = (torch.from_numpy(x) for x in chunk(2, targets=True))
    cfg, tc = EncoderConfig(**SMALL, moe_experts=moe), TrainConfig(lr=1e-3)
    single, _, step = init_training(cfg, tc, "cpu", torch.Generator().manual_seed(3))
    chunked, _, multi = init_training(cfg, tc, "cpu", torch.Generator().manual_seed(3))
    want = [step(q[k], d[k], t[k]) for k in range(K)]
    got = multi.chunked(q, d, t)
    for name in ("loss", "accuracy", "moe_aux"):
        assert torch.equal(got[name], torch.stack([m[name] for m in want])), name
    assert (got["moe_aux"] > 0).all() == bool(moe)
    for (n, a), (_, b) in zip(single.named_parameters(), chunked.named_parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(a.grad, b.grad), n          # the last step's gradients


def test_chunks_and_single_steps_continue_one_schedule():
    """A chunk after single steps and single steps after a chunk share the
    optimizer's count of updates: 2 singles, a chunk of 3, 1 single and a
    chunk of 2 equal 8 single steps bitwise under the warmup-cosine
    schedule, and the learning rate of the last update is optax's at 7."""
    tc = TrainConfig(lr=1e-2, total_steps=12, warmup_steps=3)
    q, d, _ = (None if x is None else torch.from_numpy(x) for x in chunk(4))
    q, d = torch.cat([q, q.flip(0), q[:2]]), torch.cat([d, d.flip(0), d[:2]])  # 8 batches
    ref, ref_opt, ref_step = init_training(EncoderConfig(**SMALL), tc, "cpu")
    want = [ref_step(q[i], d[i])["loss"] for i in range(8)]
    mod, opt, step = init_training(EncoderConfig(**SMALL), tc, "cpu")
    got = [step(q[0], d[0])["loss"], step(q[1], d[1])["loss"]]
    got += list(step.chunked(q[2:5], d[2:5])["loss"])
    got.append(step(q[5], d[5])["loss"])
    got += list(step.chunked(q[6:8], d[6:8])["loss"])
    assert torch.equal(torch.stack(got), torch.stack(want))
    for (n, a), (_, b) in zip(ref.named_parameters(), mod.named_parameters()):
        assert torch.equal(a, b), n
    assert opt.updates == ref_opt.updates == 8
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 12, 1e-2 * tc.min_lr_frac)
    np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched(7)), rtol=1e-6)


def test_pretrain_chunks_match_jax():
    """7 steps in chunks of 3 (3, 3 and a last single step in both
    packages) from the same weights."""
    jm = JaxModel(JaxCfg(**SMALL, dtype=jnp.float32), seed=2)
    tparams = from_jax_params(flat(jm.params))     # the JAX loop donates its params
    pre = dict(steps=7, batch_size=8, min_span=4, seed=1, steps_per_dispatch=3)
    _, jinfo = JP.pretrain_encoder(
        CORPUS, enc_cfg=JaxCfg(**SMALL, dtype=jnp.float32),
        pre_cfg=JP.PretrainConfig(**pre), train_cfg=JaxTrainConfig(lr=3e-3),
        log_every=1, init_params=jm.params)
    _, tinfo = TP.pretrain_encoder(
        CORPUS, enc_cfg=EncoderConfig(**SMALL, dtype=torch.float32),
        pre_cfg=TP.PretrainConfig(**pre), train_cfg=TrainConfig(lr=3e-3),
        device="cpu", log_every=1, init_params=tparams)
    jh, th = jinfo["history"], tinfo["history"]
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(7))
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=2e-3)
    np.testing.assert_allclose([h["accuracy"] for h in th], [h["accuracy"] for h in jh],
                               atol=1 / 8 + 1e-6)


def test_expert_counts_equal_bincount():
    """``models/moe._counts``, the MoE blocks' tokens per expert with a size
    fixed by the expert count (no host read, so the step can be captured),
    equals ``torch.bincount(e, minlength=E)`` bitwise, experts that no
    token chose included."""
    rng = np.random.default_rng(5)
    for E, T in ((4, 1), (4, 64), (8, 4096), (16, 3)):
        e = torch.from_numpy(rng.integers(0, E - 1, T))       # expert E - 1 unchosen
        got = _counts(e, E)
        want = torch.bincount(e, minlength=E)
        assert got.dtype == want.dtype and torch.equal(got, want), (E, T)
        assert got[-1] == 0
