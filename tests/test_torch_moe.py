"""The port's MoE encoder (``models/moe.py``, the MoE blocks of
``models/encoder.py``) against the JAX package's on the CPU, from the same
flax-initialised weights (carried over by ``from_jax_params``).

Tolerances.  Routing (the experts a token picks, its queue positions and
what the capacity drops) is bitwise equal to the reference's; the gates
and the load-balance term come from a softmax whose ``exp`` neither
library rounds correctly, so they agree within 3e-8 absolute (a few f32
ulps of a probability) and 1e-6 relative.  Whole encoders route tokens
alike in both packages but at near-ties of their routers (a router margin
under 1e-4 in f32 activations, 2e-2 in bf16), where a flip also shifts
the capacity queues of the two experts; embeddings are compared on the
rows all of whose tokens both route alike.  The indexed FFN equals the
dense-einsum form of the same routing bitwise (one product a slot, two
terms a token summed in f32 and rounded once).  The experts run in bf16
in both packages and round at other places: an FFN output within one
bf16 ulp of the largest (4e-3), the embeddings of a MoE encoder at a
per-row cosine of at least 0.999 in bf16 activations (max abs 0.02) and
0.999999 (max abs 1e-3) in f32 ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rag_challenge_2_tpu.models.encoder import EmbeddingModel as JaxModel
from rag_challenge_2_tpu.models.encoder import Encoder as JaxEncoder
from rag_challenge_2_tpu.models.encoder import EncoderConfig as JaxCfg
from rag_challenge_2_tpu.models.moe import MoEFFN as JaxMoE
from rag_challenge_2_tpu.models.moe import top2_dispatch as jax_dispatch
from rag_challenge_2_tpu.models.pretrain import load_params as jax_load
from rag_challenge_2_tpu.models.pretrain import save_params as jax_save
from rag_challenge_2_tpu.models.train import contrastive_loss as jax_loss
from rag_challenge_2_tpu_torch.models import MoEFFN
from rag_challenge_2_tpu_torch.models.encoder import (
    TRUNC_NORMAL_STD, EmbeddingModel, Encoder, EncoderConfig, from_jax_params,
    to_jax_params, tokenize_batch)
from rag_challenge_2_tpu_torch.models.moe import top2_dispatch
from rag_challenge_2_tpu_torch.models.pretrain import load_params, save_params
from rag_challenge_2_tpu_torch.models.train import contrastive_loss

SMALL = dict(vocab_bits=10, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_len=32, out_dim=16, moe_experts=4)
TEXTS = [f"金盘科技{2019 + i}年营业收入 {i * 7} 亿元 储能 干式变压器" for i in range(5)]


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def twins(dtype_jax, dtype_torch, seed=1):
    jm = JaxEncoder(JaxCfg(**SMALL, dtype=dtype_jax))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    tm = Encoder(EncoderConfig(**SMALL, dtype=dtype_torch))
    tm.load_state_dict(from_jax_params(flat(params)))
    return jm, params, tm


def _ties(logits, tol):
    """Tokens whose expert pair a rounding could change: the first and
    second, or the second and third probability within ``tol``."""
    p = torch.sort(torch.softmax(logits, -1), -1, descending=True)[0]
    return ((p[:, 0] - p[:, 1]) < tol) | ((p[:, 1] - p[:, 2]) < tol)


def _logits(seed, T=48, E=4):
    return np.random.default_rng(seed).normal(size=(T, E)).astype(np.float32)


def _tied():
    """Ties at both choices: tokens whose two (or three) top logits are
    equal, and tokens all of whose logits are equal."""
    lg = _logits(3)
    lg[0:6, 2] = lg[0:6, 0] = 4.0
    lg[6:9] = 1.5
    lg[9:12, 1] = lg[9:12, 3] = lg[9:12, 2] = 3.0
    return lg


def _second_after_first():
    """Expert 0 is the first choice of tokens 8-11 and the second choice of
    tokens 0-7: the second choices queue after all four first choices."""
    lg = np.zeros((12, 4), np.float32)
    lg[:8, 1], lg[:8, 0] = 5.0, 3.0
    lg[8:, 0], lg[8:, 2] = 5.0, 3.0
    return lg


@pytest.mark.parametrize("case,capacity", [
    ("random", 20),
    ("overflow", 5),                 # most experts overflow: drops in both queues
    ("tied", 12),
    ("second_after_first", 7),       # capacity cuts expert 0's second choices
])
def test_top2_dispatch_matches_jax(case, capacity):
    lg = {"random": _logits(0), "overflow": _logits(1), "tied": _tied(),
          "second_after_first": _second_after_first()}[case]
    jd, jc, ja = jax_dispatch(jnp.asarray(lg), capacity)
    td, tc, ta = top2_dispatch(torch.from_numpy(lg), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=3e-8)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    d = td.numpy()
    assert (d.sum(axis=0) <= 1).all() and (d.sum(axis=(1, 2)) <= 2).all()
    if case == "overflow":
        assert d.sum() < 2 * lg.shape[0]
    if case == "second_after_first":
        # first choices fill slots 0-3 of expert 0, second choices 4-6,
        # and the capacity of 7 drops tokens 3-7's second choice
        assert d[8:, 0, :4].argmax(1).tolist() == [0, 1, 2, 3]
        assert d[:3, 0, 4:].argmax(1).tolist() == [0, 1, 2]
        assert d[3:8, 0].sum() == 0


@pytest.mark.parametrize("case", ["random", "overflow", "tied", "second_after_first"])
def test_moe_routing_matches_jax_dispatch(case):
    """``MoEFFN.routing`` (what the block does with its router's logits)
    keeps exactly the (token, expert) pairs that the reference's dispatch
    at the reference's capacity ``int(1.25 T / E)`` keeps."""
    lg = {"random": _logits(0), "overflow": _logits(1, T=40), "tied": _tied(),
          "second_after_first": _second_after_first()}[case]
    T, E = lg.shape
    moe = MoEFFN(E, 8, 8)
    assert moe.capacity(T) == max(1, int(1.25 * T / E))
    r = moe.routing(torch.from_numpy(lg)).numpy()
    kept = np.zeros((T, E), bool)
    for col, keep in ((0, 2), (1, 3)):
        kept[np.arange(T)[r[:, keep] == 1], r[r[:, keep] == 1, col]] = True
    jd, _, _ = jax_dispatch(jnp.asarray(lg), moe.capacity(T))
    np.testing.assert_array_equal(kept, np.asarray(jd).sum(-1) > 0)
    assert (r[:, 0] != r[:, 1]).all()


def _moe_twins(seed=0, D=32, Fh=64, E=4, shape=(3, 16)):
    jm = JaxMoE(n_experts=E, d_model=D, d_ff=Fh)
    x = np.random.default_rng(seed).normal(size=(*shape, D)).astype(np.float32)
    p = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    pp = p["params"]
    tm = MoEFFN(E, D, Fh)
    tm.load_state_dict({
        "router.weight": torch.from_numpy(np.asarray(pp["router"]["kernel"]).T.copy()),
        "router.bias": torch.from_numpy(np.array(pp["router"]["bias"])),
        "w_in": torch.from_numpy(np.array(pp["w_in"])),
        "w_out": torch.from_numpy(np.array(pp["w_out"]))})
    return jm, p, tm, x


@pytest.mark.parametrize("seed,shape", [(0, (3, 16)), (1, (8, 20))])
def test_indexed_moe_equals_dense_einsum(seed, shape):
    """The gather / batched FFN / gather form equals the reference's four
    einsums over the dense dispatch and combine tensors, bitwise, and its
    load-balance term equals ``top2_dispatch``'s."""
    _, _, tm, x = _moe_twins(seed, shape=shape)
    with torch.no_grad():
        out, aux = tm(torch.from_numpy(x))
        xt = torch.from_numpy(x).reshape(-1, 32)
        logits = F.linear(xt, tm.router.weight, tm.router.bias)
        C = int(1.25 * xt.shape[0] / 4)
        disp, comb, daux = top2_dispatch(logits, C)
        bf = torch.bfloat16
        ein = torch.einsum("tec,td->ecd", disp.to(bf), xt.to(bf))
        h = F.gelu(torch.einsum("ecd,edf->ecf", ein, tm.w_in.to(bf)), approximate="tanh")
        eo = torch.einsum("ecf,efd->ecd", h, tm.w_out.to(bf))
        dense = torch.einsum("tec,ecd->td", comb.to(bf), eo)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    torch.testing.assert_close(out.reshape(-1, 32), dense, rtol=0, atol=0)
    torch.testing.assert_close(aux, daux, rtol=1e-6, atol=0)


def test_moe_ffn_matches_flax_apply():
    jm, p, tm, x = _moe_twins()
    jout, sown = jm.apply(p, jnp.asarray(x), mutable=["losses"])
    with torch.no_grad():
        tout, aux = tm(torch.from_numpy(x))
        logits = F.linear(torch.from_numpy(x).reshape(-1, 32), tm.router.weight,
                          tm.router.bias)
    assert not _ties(logits, 1e-4).any()
    jo = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(tout.float().numpy(), jo, rtol=0, atol=4e-3)
    # the sown tuple holds init's value and this apply's
    np.testing.assert_allclose(aux.item(), float(sown["losses"]["moe_aux"][-1]), rtol=1e-6)


def _routing(logits):
    """``[T, 4]``: each token's two experts and whether the capacity kept
    each, as a MoE block computes them from its router logits."""
    from rag_challenge_2_tpu_torch.models.moe import _positions, _route

    _, e1, _, e2, _ = _route(logits.float())
    C = max(1, int(1.25 * logits.shape[0] / logits.shape[1]))
    p1, p2 = _positions(e1, e2, logits.shape[1])
    return torch.stack([e1, e2, (p1 < C).long(), (p2 < C).long()], 1)


def _port_logits(tm, ids):
    """Each MoE block's router logits in one forward of the port's ``tm``."""
    seen = []
    hooks = [blk.moe.router.register_forward_hook(lambda m, i, o: seen.append(o))
             for blk in tm.blocks if hasattr(blk, "moe")]
    with torch.no_grad():
        tm(torch.as_tensor(ids))
    for h in hooks:
        h.remove()
    assert len(seen) == len(hooks) > 0
    return seen


def _jax_logits(jm, params, ids):
    """Each MoE block's router logits in one forward of the reference."""
    _, st = jm.apply(params, jnp.asarray(ids), capture_intermediates=True,
                     mutable=["intermediates", "losses"])
    blocks = st["intermediates"]
    return [torch.from_numpy(np.array(blocks[b]["moe"]["router"]["__call__"][0]))
            for b in sorted(blocks) if b.startswith("block") and "moe" in blocks[b]]


def _clear_rows(tm, jm, params, ids, margin):
    """Rows all of whose tokens (padding included) each package routes
    alike (the same two experts, the same capacity drops); every expert
    pair that differs must sit at a router near-tie (``margin``)."""
    B, L = ids.shape
    clear = torch.ones(B, dtype=torch.bool)
    for t, j in zip(_port_logits(tm, ids), _jax_logits(jm, params, ids)):
        rt, rj = _routing(t), _routing(j)
        pair = (rt[:, :2] != rj[:, :2]).any(1)
        assert not pair.any() or _ties(t, margin)[pair].all()
        clear &= ~(rt != rj).any(1).view(B, L).any(1)
    return clear.numpy()


def _rng_ids(seed, B, L, pad_rows=(3,)):
    ids = np.random.default_rng(seed).integers(0, 1 << SMALL["vocab_bits"], (B, L))
    ids = ids.astype(np.int32)
    for r in pad_rows:
        ids[r, L // 2:] = -1
    return ids


@pytest.mark.parametrize("dtype,cos_min,atol", [
    ("float32", 0.999999, 1e-3), ("bfloat16", 0.999, 0.02)])
def test_moe_encoder_matches_jax(dtype, cos_min, atol):
    jm, params, tm = twins(getattr(jnp, dtype), getattr(torch, dtype))
    ids = _rng_ids(2, 8, 16)
    j = np.asarray(jm.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        t, aux = tm(torch.from_numpy(ids), return_aux=True)
    t = t.numpy()
    clear = _clear_rows(tm, jm, params, ids, 1e-4 if dtype == "float32" else 2e-2)
    assert clear.sum() >= 4, clear
    cos = (t * j).sum(1)[clear]
    assert cos.min() >= cos_min, cos
    assert np.abs(t - j)[clear].max() <= atol
    _, sown = jm.apply(params, jnp.asarray(ids), mutable=["losses"])
    np.testing.assert_allclose(aux.item(), float(sown["losses"]["block1"]["moe"]["moe_aux"][-1]),
                               rtol=1e-3)


def test_embed_pads_to_the_reference_bucket():
    """``EmbeddingModel.embed`` pads a batch of 5 texts with 3 rows of -1
    (``_bucket``: 8) as the reference does; a MoE encoder routes those rows
    too, so the port's embeddings equal the reference's ``embed`` and not
    an unpadded forward of the 5 texts."""
    jmod = JaxModel(JaxCfg(**SMALL), seed=4)
    tmod = EmbeddingModel(EncoderConfig(**SMALL), params=from_jax_params(flat(jmod.params)),
                          device="cpu")
    assert [tmod._bucket(n, 512) for n in (1, 5, 8, 9, 300, 600)] == \
        [JaxModel._bucket(n, 512) for n in (1, 5, 8, 9, 300, 600)]
    ids = tokenize_batch(TEXTS, SMALL["max_len"], SMALL["vocab_bits"], bucket_len=True)
    padded = np.pad(ids, ((0, 3), (0, 0)), constant_values=-1)
    clear = _clear_rows(tmod.module, jmod.module, jmod.params, padded, 2e-2)[:5]
    assert clear.sum() >= 2, clear
    j, t = jmod.embed(TEXTS), tmod.embed(TEXTS)
    assert t.shape == (5, SMALL["out_dim"])
    cos = (t * j).sum(1)[clear]
    assert cos.min() >= 0.999 and np.abs(t - j)[clear].max() <= 0.02, cos
    unpadded = tmod.embed_tokens(torch.from_numpy(ids)).numpy()
    assert not np.allclose(unpadded, t, atol=1e-6)
    np.testing.assert_array_equal(tmod.embed_tokens(torch.from_numpy(padded)).numpy()[:5], t)


def test_dense_embed_goes_unpadded():
    """A dense encoder's rows are independent, so ``embed_device`` hands
    it each batch as it is: 5 texts are 5 rows, with no padding rows."""
    cfg = EncoderConfig(**dict(SMALL, moe_experts=0))
    tmod = EmbeddingModel(cfg, device="cpu")
    seen = []
    hook = tmod.module.register_forward_hook(lambda _m, inp, _o: seen.append(inp[0].shape[0]))
    got = tmod.embed(TEXTS)
    hook.remove()
    assert seen == [len(TEXTS)] and got.shape == (len(TEXTS), SMALL["out_dim"])
    ids = tokenize_batch(TEXTS, SMALL["max_len"], SMALL["vocab_bits"], bucket_len=True)
    np.testing.assert_array_equal(tmod.embed_tokens(torch.from_numpy(ids)).numpy(), got)


def test_expert_init_std_counts_the_expert_axis():
    """flax's ``lecun_normal`` on ``[E, D, F]`` takes ``fan_in = D·E``; the
    port draws the experts so, truncated at two stds, as flax does."""
    cfg = dict(SMALL, d_model=128, d_ff=256)
    jflat = flat(JaxEncoder(JaxCfg(**cfg)).init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8), jnp.int32)))
    tm = Encoder(EncoderConfig(**cfg))
    tm.init_weights(torch.Generator().manual_seed(0))
    w_in, w_out = tm.blocks[1].moe.w_in.detach().numpy(), tm.blocks[1].moe.w_out.detach().numpy()
    for w, j, fan_in in ((w_in, jflat["params/block1/moe/w_in"], 128 * 4),
                         (w_out, jflat["params/block1/moe/w_out"], 256 * 4)):
        target = 1 / np.sqrt(fan_in)
        assert abs(w.std() / target - 1) < 0.03 and abs(j.std() / target - 1) < 0.03
        assert np.abs(w).max() <= 2 * target / TRUNC_NORMAL_STD * (1 + 1e-6)
    np.testing.assert_array_equal(tm.blocks[1].moe.router.bias.detach().numpy(), 0)


def test_moe_npz_loads_both_ways(tmp_path):
    """A port-written MoE npz carries the reference's whole tree, the sown
    ``losses/…`` leaf included, so the reference's ``load_params`` takes it
    and embeds as the port does; a reference-written npz loads into the
    port bitwise."""
    jmod = JaxModel(JaxCfg(**SMALL), seed=5)
    tmod = EmbeddingModel(EncoderConfig(**SMALL), params=from_jax_params(flat(jmod.params)),
                          device="cpu")
    save_params(tmod, tmp_path / "port.npz")
    with np.load(tmp_path / "port.npz") as z:
        assert set(z.files) == set(flat(jmod.params))
        assert z["losses/block1/moe/moe_aux/[0]"].shape == () and \
            float(z["losses/block1/moe/moe_aux/[0]"]) == 0.0
    back = jax_load(JaxModel(JaxCfg(**SMALL), seed=9), tmp_path / "port.npz")
    for k, v in flat(back.params).items():
        if k.startswith("params/"):
            np.testing.assert_array_equal(v, flat(jmod.params)[k], err_msg=k)
    jax_save(jmod, tmp_path / "jax.npz")
    mod2 = load_params(EmbeddingModel(EncoderConfig(**SMALL), device="cpu"),
                       tmp_path / "jax.npz")
    for k, v in tmod.module.state_dict().items():
        assert torch.equal(v, mod2.module.state_dict()[k]), k
    sd = to_jax_params(tmod.module.state_dict(), SMALL["n_heads"])
    assert {k: v.shape for k, v in sd.items()} == \
        {k: v.shape for k, v in flat(jmod.params).items()}


def test_contrastive_loss_moe_departs_by_the_stale_aux():
    """The reference's ``init_training`` keeps init's sown load-balance
    value in its params, and each of a step's two forwards adds it to
    ``moe_aux``.  Pinned by value: the port's ``moe_aux`` is the
    reference's minus twice that constant (1e-6 relative: the fresh terms
    agree to f32 ulps), its loss the reference's minus ``moe_aux_weight``
    times it (within 1e-3 relative: bf16 experts), and q and d are routed
    in separate forwards."""
    jm, params, tm = twins(jnp.float32, torch.float32)
    q, d = _rng_ids(3, 8, 12), _rng_ids(4, 8, 14)
    stale = sum(float(v) for k, v in flat(params).items() if k.startswith("losses/"))
    assert stale > 0.5
    jl, jmet = jax_loss(params, lambda p, t: jm.apply(p, t, mutable=["losses"]),
                        jnp.asarray(q), jnp.asarray(d), 0.05, 0.01)
    tl, tmet = contrastive_loss(tm, torch.from_numpy(q), torch.from_numpy(d), 0.05, 0.01)
    np.testing.assert_allclose(tmet["moe_aux"].item(), float(jmet["moe_aux"]) - 2 * stale,
                               rtol=1e-6)
    np.testing.assert_allclose(tl.item(), float(jl) - 0.01 * 2 * stale, rtol=1e-3)
    with torch.no_grad():
        _, qa = tm(torch.from_numpy(q), return_aux=True)
        _, da = tm(torch.from_numpy(d), return_aux=True)
    torch.testing.assert_close(tmet["moe_aux"], qa + da, rtol=0, atol=0)
