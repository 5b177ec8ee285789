"""Encoder training on the card against the same work on the CPU.

These need a CUDA card and skip without one; run them on the H100 with
``python -m pytest --noconftest tests/test_torch_train_card.py -m cuda``
(the repository conftest imports jax, which that machine lacks).

One train step of a narrow encoder (d_model 128, 2 blocks, batch 32) from
the same weights and batch, in f32 and bf16 activations: loss within
1e-4 relative (f32) / 2e-2 (bf16), every gradient's cosine to the CPU's
at least 0.9999 / 0.99, and the parameters after the step within 1e-6
wherever the gradient's sign is sure (|g| >= 1e-3 of its tensor's largest, or 0 on
both), all of them in f32 and all but 0.1% in bf16.  Attention's key bias is
left out of both: its gradient is 0 in exact arithmetic, so each side's
value is rounding and Adam moves the bias by lr times that noise's sign.  The device BM25
teacher (``host_teacher=False``: ``bm25_scores`` through kernel K2)
against ``HostBM25Scorer`` within ``rtol = atol = 2e-5``.  The chunked
step (``step.chunked``: one step captured as a CUDA graph and replayed)
against as many eager steps from the same weights: metrics and every
parameter bitwise, in f32 and bf16, a chunk and single steps continuing
one learning-rate schedule."""

import numpy as np
import pytest
import torch

from rag_challenge_2_tpu_torch.models.encoder import Encoder, EncoderConfig, tokenize_batch
from rag_challenge_2_tpu_torch.models.pretrain import PairSampler, PretrainConfig
from rag_challenge_2_tpu_torch.models.train import (
    TrainConfig, init_training, make_optimizer, make_train_step)

pytestmark = pytest.mark.cuda

CFG = dict(vocab_bits=12, d_model=128, n_layers=2, n_heads=4, d_ff=256, max_len=64,
           out_dim=64)
CORPUS = [f"公司{c}在{y}年的营业收入为{v}亿元，同比增长{v % 7}个百分点，主要来自{s}业务"
          for c, s in zip("甲乙丙丁", ("储能系统", "干式变压器", "海上风电", "光伏逆变器"))
          for y, v in zip(range(2015, 2025), range(11, 21))] + [
    "注：营业收入（亦称营收、销售收入）指报告期内相关口径下的财务指标。"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_on_the_card_equals_the_cpu(dev, dtype):
    f32 = dtype == torch.float32
    cfg = EncoderConfig(**CFG, dtype=dtype)
    pre = PretrainConfig(batch_size=32, min_span=4)
    qs, ps, _ = PairSampler(CORPUS, pre, device="cpu").sample(np.random.default_rng(0))
    q = torch.from_numpy(tokenize_batch(qs, 48, cfg.vocab_bits))
    p = torch.from_numpy(tokenize_batch(ps, 48, cfg.vocab_bits))
    init = Encoder(cfg)
    init.init_weights(torch.Generator().manual_seed(0))
    tc = TrainConfig(lr=3e-4)
    out = {}
    for where in (dev, torch.device("cpu")):
        mod = Encoder(cfg)
        mod.load_state_dict(init.state_dict())
        mod.to(where)
        step = make_train_step(mod, make_optimizer(mod.parameters(), tc), tc)
        out[where.type] = (step(q, p), mod)
    (gm, gmod), (cm, cmod) = out["cuda"], out["cpu"]
    assert gm["loss"].device.type == "cuda"
    rel = abs(gm["loss"].item() - cm["loss"].item()) / abs(cm["loss"].item())
    assert rel <= (1e-4 if f32 else 2e-2)
    compared = off = 0
    for (n, gp), (_, cp) in zip(gmod.named_parameters(), cmod.named_parameters()):
        if n.endswith(".key.bias"):     # rounding on both sides: not compared
            continue
        g, c = gp.grad.cpu().double(), cp.grad.double()
        top = c.abs().max()
        if top > 0:
            cos = float(g.flatten() @ c.flatten() / (g.norm() * c.norm()))
            assert cos >= (0.9999 if f32 else 0.99), (n, cos)
        sure = (c.abs() >= 1e-3 * top) | ((c == 0) & (g == 0))
        compared += int(sure.sum())
        off += int(((gp.detach().cpu() - cp.detach()).abs()[sure] > 1e-6).sum())
    assert off <= (0 if f32 else 1e-3 * compared), (off, compared)


def test_device_teacher_on_the_card_equals_the_host_teacher(dev):
    from rag_challenge_2_tpu_torch.ops.span_gather import gather_posting_spans

    host = PairSampler(CORPUS, PretrainConfig(min_span=4), device=dev)
    card = PairSampler(CORPUS, PretrainConfig(min_span=4, host_teacher=False), device=dev)
    assert host._host_scorer is not None and card._host_scorer is None
    assert card._sparse.indptr.device.type == "cuda"
    rng = np.random.default_rng(1)
    queries = [card._crop(CORPUS[int(i)], rng) for i in rng.integers(0, len(CORPUS), 48)]
    before = gather_posting_spans.launches
    a = card._teacher_scores(queries)
    assert gather_posting_spans.launches == before + 1
    np.testing.assert_allclose(a, host._teacher_scores(queries), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_step_replays_a_graph_equal_to_eager_steps(dev, dtype):
    cfg = EncoderConfig(**CFG, dtype=dtype)
    pre = PretrainConfig(batch_size=32, min_span=4, soft_target_weight=0.8)
    sampler = PairSampler(CORPUS, pre, device="cpu")
    rng = np.random.default_rng(2)
    qs, ps, ts = zip(*[sampler.sample(rng) for _ in range(6)])
    q = torch.from_numpy(np.stack([tokenize_batch(x, 48, cfg.vocab_bits) for x in qs])).to(dev)
    p = torch.from_numpy(np.stack([tokenize_batch(x, 48, cfg.vocab_bits) for x in ps])).to(dev)
    t = torch.from_numpy(np.stack(ts)).to(dev)
    tc = TrainConfig(lr=3e-4, total_steps=20, warmup_steps=2)
    eager, _, estep = init_training(cfg, tc, dev, torch.Generator().manual_seed(1))
    graph, gopt, gstep = init_training(cfg, tc, dev, torch.Generator().manual_seed(1))
    want = [estep(q[k], p[k], t[k]) for k in range(6)]
    got = gstep.chunked(q[:4], p[:4], t[:4])                 # captured, replayed 4 times
    more = [gstep(q[4], p[4], t[4])] + [gstep.chunked(q[5:], p[5:], t[5:])]
    loss = torch.cat([got["loss"], more[0]["loss"][None], more[1]["loss"]])
    assert torch.equal(loss, torch.stack([m["loss"] for m in want]))
    assert torch.equal(got["accuracy"], torch.stack([m["accuracy"] for m in want[:4]]))
    assert gopt.updates == 6
    for (n, a), (_, b) in zip(eager.named_parameters(), graph.named_parameters()):
        assert torch.equal(a, b), n
