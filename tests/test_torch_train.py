"""The port's contrastive training (``models/train.py``) and the encoder's
trainable side (``models/encoder.py``: flax's initialisation, the weights
carried back to the reference's layout) held against the JAX package on
the CPU, at a small config, from the same flax-initialised weights
(carried over by ``from_jax_params``).

Tolerances: f32 activations give the loss within 1e-5 relative, each
gradient within 1e-4 relative / 1e-6 absolute of its tensor's largest
element (sums in another order), but attention's key bias, whose
gradient is 0 in exact arithmetic: both packages' values stay under 1e-4
of the model's largest gradient (1e-2 in bf16); after one AdamW step the parameters
agree within 1e-6 wherever |g| is at least 1e-3 of the tensor's largest
gradient or the gradient is 0 in both (the first Adam update is
``lr * g / (|g| + eps)``, about ``lr * sign(g)``, and a tiny gradient's
sign is rounding); the others, and the key bias, under 5%, are counted.  bf16 activations round at other places than XLA's: the loss
within 2e-2 relative and every gradient at a cosine of at least 0.99 to
the reference's.  Learning rates equal optax's schedule within 1e-6
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rag_challenge_2_tpu.models.encoder import Encoder as JaxEncoder
from rag_challenge_2_tpu.models.encoder import EncoderConfig as JaxCfg
from rag_challenge_2_tpu.models.train import TrainConfig as JaxTrainConfig
from rag_challenge_2_tpu.models.train import contrastive_loss as jax_loss
from rag_challenge_2_tpu.models.train import make_optimizer as jax_optimizer
from rag_challenge_2_tpu_torch.models import encoder as E
from rag_challenge_2_tpu_torch.models.encoder import (
    Encoder, EncoderConfig, from_jax_params, to_jax_params, tokenize_batch)
from rag_challenge_2_tpu_torch.models.train import (
    TrainConfig, contrastive_loss, init_training, lr_schedule, make_optimizer,
    make_train_step)

SMALL = dict(vocab_bits=10, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_len=32, out_dim=16)
QUERIES = ["金盘科技2023年营业收入", "净利润 5.03 亿", "宁德时代 研发投入",
           "储能系统 干式变压器", "hello world 2024", "毛利率 同比 增长",
           "经营活动现金流量净额", "海外收入占比 提升"]
PASSAGES = [q + " 详见年度报告第三节" for q in QUERIES[::-1]]


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def twins(dtype_jax, dtype_torch, seed=1):
    """The flax encoder's params and the port's Encoder on the same weights."""
    jm = JaxEncoder(JaxCfg(**SMALL, dtype=dtype_jax))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    tm = Encoder(EncoderConfig(**SMALL, dtype=dtype_torch))
    tm.load_state_dict(from_jax_params(flat(params)))
    return jm, params, tm


def tokens(texts, L=24):
    return tokenize_batch(texts, L, SMALL["vocab_bits"])


def soft_targets(B, w=0.6, seed=0):
    p = np.random.default_rng(seed).random((B, B)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    return ((1 - w) * np.eye(B, dtype=np.float32) + w * p).astype(np.float32)


def jax_apply(jm):
    return lambda p, t: jm.apply(p, t, mutable=["losses"])


@pytest.mark.parametrize("soft", [False, True])
def test_contrastive_loss_matches_jax(soft):
    jm, params, tm = twins(jnp.float32, torch.float32)
    q, d = tokens(QUERIES), tokens(PASSAGES)
    t = soft_targets(len(QUERIES)) if soft else None
    jl, jmet = jax_loss(params, jax_apply(jm), jnp.asarray(q), jnp.asarray(d), 0.05,
                        0.01, None if t is None else jnp.asarray(t))
    tl, tmet = contrastive_loss(tm, torch.from_numpy(q), torch.from_numpy(d), 0.05,
                                0.01, None if t is None else torch.from_numpy(t))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert tmet["accuracy"].item() == float(jmet["accuracy"])
    assert tmet["moe_aux"].item() == float(jmet["moe_aux"]) == 0.0


def test_soft_identity_targets_equal_integer_labels():
    _, _, tm = twins(jnp.float32, torch.float32)
    q, d = torch.from_numpy(tokens(QUERIES)), torch.from_numpy(tokens(PASSAGES))
    hard, _ = contrastive_loss(tm, q, d, 0.05)
    soft, _ = contrastive_loss(tm, q, d, 0.05, targets=torch.eye(len(QUERIES)))
    torch.testing.assert_close(hard, soft, rtol=1e-6, atol=0)


def _step_both(dtype_jax, dtype_torch, tc_kw):
    """One optimiser step in both packages from the same weights and batch:
    (jax loss, jax grads, jax params after, port loss, port step's module)."""
    jm, params, tm = twins(dtype_jax, dtype_torch)
    q, d = tokens(QUERIES), tokens(PASSAGES)
    jtc = JaxTrainConfig(**tc_kw)
    (jl, _), grads = jax.value_and_grad(jax_loss, has_aux=True)(
        params, jax_apply(jm), jnp.asarray(q), jnp.asarray(d), jtc.temperature,
        jtc.moe_aux_weight)
    opt = jax_optimizer(jtc)
    updates, _ = opt.update(grads, opt.init(params), params)
    after = optax.apply_updates(params, updates)
    tc = TrainConfig(**tc_kw)
    step = make_train_step(tm, make_optimizer(tm.parameters(), tc), tc)
    metrics = step(torch.from_numpy(q), torch.from_numpy(d))
    return (float(jl), from_jax_params(flat(grads)), from_jax_params(flat(after)),
            metrics, tm)


def assert_rounded_zero(got, ref, tol):
    """Attention's key bias has a gradient of 0 in exact arithmetic (the
    softmax ignores a shift shared by all keys): both packages' values are
    rounding, held under ``tol`` (a fraction of the model's largest
    gradient), not compared with each other."""
    assert got.abs().max().item() <= tol and ref.abs().max().item() <= tol


def test_one_train_step_f32_matches_jax():
    jl, jg, jafter, metrics, tm = _step_both(jnp.float32, torch.float32,
                                             dict(lr=1e-3))
    np.testing.assert_allclose(metrics["loss"].item(), jl, rtol=1e-5)
    counted = compared = 0
    top = max(g.abs().max().item() for g in jg.values())
    for name, p in tm.named_parameters():
        g = p.grad
        if name.endswith(".key.bias"):
            # Adam moves it by lr times the sign of each side's rounding
            assert_rounded_zero(g, jg[name], 1e-4 * top)
            counted += g.numel()
            continue
        big = jg[name].abs().max().item()
        torch.testing.assert_close(g, jg[name], rtol=1e-4, atol=1e-6 * big)
        # rows no token reached have no gradient in either package: their
        # update is the weight decay alone, compared too
        sure = (jg[name].abs() >= 1e-3 * big) | ((jg[name] == 0) & (g == 0))
        torch.testing.assert_close(p.detach()[sure], jafter[name][sure],
                                   rtol=0, atol=1e-6)
        compared += int(sure.sum())
        counted += int((~sure).sum())
    # the counted elements are few (tiny gradients of any sign)
    assert counted < 0.05 * (compared + counted), (compared, counted)


def test_one_train_step_bf16_matches_jax():
    jl, jg, _, metrics, tm = _step_both(jnp.bfloat16, torch.bfloat16, dict(lr=1e-3))
    np.testing.assert_allclose(metrics["loss"].item(), jl, rtol=2e-2)
    top = max(g.abs().max().item() for g in jg.values())
    for name, p in tm.named_parameters():
        if name.endswith(".key.bias"):
            assert_rounded_zero(p.grad, jg[name], 1e-2 * top)
            continue
        a, b = p.grad.flatten().double(), jg[name].flatten().double()
        if b.abs().max() == 0:
            assert a.abs().max() == 0, name
            continue
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= 0.99, (name, cos)


@pytest.mark.parametrize("tc_kw", [
    dict(lr=1e-2),                                        # constant
    dict(lr=1e-2, total_steps=20, warmup_steps=5),        # warmup 2 (20 // 10)
    dict(lr=3e-3, total_steps=12, warmup_steps=100, min_lr_frac=0.1),
    dict(lr=1e-2, total_steps=6, warmup_steps=0),         # no warmup
], ids=["constant", "warmup_cosine", "warmup_capped", "cosine_only"])
def test_lr_sequence_matches_optax(tc_kw):
    """The lr of every update (read back from the port's AdamW after each
    train step) equals optax's schedule at the count of updates before it,
    past the end of the decay too; and AdamW under that schedule moves a
    parameter as optax's ``adamw`` does."""
    tc, jtc = TrainConfig(**tc_kw), JaxTrainConfig(**tc_kw)
    n = max(tc.total_steps, 4) + 3
    if tc.total_steps > 0:
        sched = optax.warmup_cosine_decay_schedule(
            0.0, jtc.lr, min(jtc.warmup_steps, max(jtc.total_steps // 10, 1)),
            jtc.total_steps, jtc.lr * jtc.min_lr_frac)
        want = [float(sched(jnp.int32(i))) for i in range(n)]
    else:
        want = [jtc.lr] * n
    _, optimizer, step = init_training(EncoderConfig(**SMALL), tc, "cpu",
                                       torch.Generator().manual_seed(0))
    q, d = torch.from_numpy(tokens(QUERIES)), torch.from_numpy(tokens(PASSAGES))
    got = []
    for _ in range(n):
        step(q, d)
        got.append(optimizer.param_groups[0]["lr"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    if tc.total_steps > 0 and tc.warmup_steps > 0:
        assert got[0] == 0.0                      # the first update has lr 0

    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(6,)).astype(np.float32)
    grads = rng.normal(size=(n, 6)).astype(np.float32)
    jopt = jax_optimizer(jtc)
    jp, st = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt, schedule = make_optimizer([tp], tc), lr_schedule(tc)
    for i in range(n):
        upd, st = jopt.update(jnp.asarray(grads[i]), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(grads[i])
        topt.param_groups[0]["lr"] = schedule(i)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_step_keeps_metrics_on_the_device():
    module, _, step = init_training(EncoderConfig(**SMALL), TrainConfig(), "cpu")
    m = step(torch.from_numpy(tokens(QUERIES)), torch.from_numpy(tokens(PASSAGES)))
    assert set(m) == {"loss", "accuracy", "moe_aux"}
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in m.values())
    assert not m["loss"].requires_grad
    assert all(p.grad is not None for p in module.parameters())


def test_train_config_fields_match_jax():
    import dataclasses

    got = [(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
    assert got == [(f.name, f.default) for f in dataclasses.fields(JaxTrainConfig)]
    assert got[0] == ("lr", 1e-4)


def test_moe_experts_raise_until_multi_gpu():
    """``moe_experts > 0`` no longer raises: the odd blocks take the MoE FFN
    (``models/moe.py``, held against the reference in
    ``tests/test_torch_moe.py``), and a step trains it."""
    from rag_challenge_2_tpu_torch.models import MoEFFN

    module, _, step = init_training(EncoderConfig(**SMALL, moe_experts=4), TrainConfig(),
                                    "cpu")
    assert [hasattr(b, "moe") for b in module.blocks] == [False, True]
    assert isinstance(module.blocks[1].moe, MoEFFN) and not hasattr(module.blocks[1], "mlp_in")
    m = step(torch.from_numpy(tokens(QUERIES)), torch.from_numpy(tokens(PASSAGES)))
    assert m["moe_aux"].item() > 0 and module.blocks[1].moe.w_in.grad.abs().sum() > 0


@pytest.mark.parametrize("shape_cfg", [
    dict(vocab_bits=10, d_model=256, n_layers=1, n_heads=4, d_ff=512,
         max_len=64, out_dim=128),
    dict(vocab_bits=9, d_model=128, n_layers=1, n_heads=8, d_ff=1024,
         max_len=32, out_dim=256),
])
def test_initialisation_matches_flax_distributions(shape_cfg):
    """Per tensor, the port's random draw and flax's at the same shapes:
    stds within 5% of each other (and of the target: ``1/sqrt(fan_in)``
    for kernels and embeddings), the kernels' max |w| at most the
    truncation point ``2 * std / 0.8796`` and within 10% of flax's;
    biases and LayerNorms equal."""
    jm = JaxEncoder(JaxCfg(**shape_cfg))
    jflat = flat(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    tm = Encoder(EncoderConfig(**shape_cfg))
    tm.init_weights(torch.Generator().manual_seed(0))
    tflat = to_jax_params(tm.state_dict(), shape_cfg["n_heads"])
    assert set(tflat) == set(jflat)
    d = shape_cfg["d_model"]
    for key, jw in jflat.items():
        tw = tflat[key]
        assert tw.shape == jw.shape and tw.dtype == np.float32, key
        if key.endswith(("/bias", "/scale")):
            np.testing.assert_array_equal(tw, jw, err_msg=key)
            continue
        if key.endswith("/embedding"):
            target, cut = 1 / np.sqrt(d), None
        else:
            fan_in = jw.shape[0] if not key.endswith("attn/out/kernel") \
                else jw.shape[0] * jw.shape[1]
            target = 1 / np.sqrt(fan_in)
            cut = 2 * target / E.TRUNC_NORMAL_STD
        for w in (tw, jw):
            assert abs(w.std() / target - 1) < 0.05, (key, w.std(), target)
        assert abs(tw.std() / jw.std() - 1) < 0.05, key
        if cut is not None:
            assert np.abs(tw).max() <= cut * (1 + 1e-6), key
            assert abs(np.abs(tw).max() / np.abs(jw).max() - 1) < 0.1, key


def test_to_jax_params_inverts_from_jax_params():
    """The flax layout and back, bitwise, at every key and shape."""
    _, params, tm = twins(jnp.bfloat16, torch.bfloat16, seed=4)
    jflat = flat(params)
    back = to_jax_params(tm.state_dict(), SMALL["n_heads"])
    assert set(back) == set(jflat)
    for k, v in jflat.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
