"""The port's self-supervised pretraining (``models/pretrain.py``) and the
host BM25 teacher (``ops/bm25.HostBM25Scorer``) held against the JAX
package on the CPU.

* The sampler is a host copy: 20 draws in every mode (crop / ICT, BM25
  neighbour, hard batch, listwise, alias swap on both sides, question
  frames, idf sampling, a custom teacher) equal the JAX sampler's string
  for string from the same numpy seed, soft targets bitwise.
* ``HostBM25Scorer`` is bitwise equal to the JAX one over each package's
  own CSR; the device teacher (``bm25_scores``) agrees with it within
  ``rtol = atol = 2e-5`` (the JAX package's own bound, tests/test_models.py).
* A 10-step ``pretrain_encoder`` from the same flax-initialised weights
  (f32 activations, small config) follows the JAX package's loss
  trajectory within 2e-3 relative (sums in another order, compounded by
  Adam's sign-like early updates) and its accuracy within one example.
* ``steps_per_dispatch`` 1 against 3 is bitwise; ``save_params`` /
  ``load_params`` round trips are bitwise in both directions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rag_challenge_2_tpu.models.pretrain as JP
import rag_challenge_2_tpu_torch.models.pretrain as TP
from rag_challenge_2_tpu.models.encoder import EmbeddingModel as JaxModel
from rag_challenge_2_tpu.models.encoder import EncoderConfig as JaxCfg
from rag_challenge_2_tpu.models.train import TrainConfig as JaxTrainConfig
from rag_challenge_2_tpu_torch.models.encoder import (
    EmbeddingModel, EncoderConfig, from_jax_params, load_params_npz)
from rag_challenge_2_tpu_torch.models.train import TrainConfig

SMALL = dict(vocab_bits=10, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_len=32, out_dim=16)

CORPUS = [
    f"公司{c}在{y}年的营业收入为{v}亿元，同比增长{v % 7}个百分点，主要来自{s}业务"
    for c, s in zip("甲乙丙", ("储能系统", "干式变压器", "海上风电"))
    for y, v in zip(range(2017, 2025), range(11, 19))
] + [
    "注：营业收入（亦称营收、销售收入）指报告期内相关口径下的财务指标。",
    "注：归母净利润（又称归属股东的净利润）指公司报告期内的利润指标。",
    "本公司经营活动现金流（亦称经营现金流，下同）保持稳定增长态势。",
    "公司2023年归母净利润为3.2亿元，较上年同期增长，研发投入持续加大。",
    "稀有词汇：钒液流电池 固态电解质 钠离子 氢燃料 储热熔盐 飞轮储能",
]

MODES = {
    "crop_ict": dict(bm25_neighbor_prob=0.0, hard_batch_prob=0.0,
                     alias_swap_prob=0.0),
    "removal_ict": dict(crop_prob=0.0, keep_span_prob=0.0, bm25_neighbor_prob=0.0,
                        hard_batch_prob=0.0, alias_swap_prob=0.0),
    "neighbour": dict(bm25_neighbor_prob=1.0, hard_batch_prob=0.0,
                      alias_swap_prob=0.0),
    "hard_batch": dict(bm25_neighbor_prob=0.0, hard_batch_prob=1.0,
                       alias_swap_prob=0.0),
    "listwise": dict(bm25_neighbor_prob=0.0, hard_batch_prob=0.5,
                     soft_target_weight=0.8, alias_swap_prob=0.0),
    "alias_both_sides": dict(alias_swap_prob=0.8, alias_swap_passage_prob=0.5),
    "question_wrap": dict(question_wrap_prob=0.7),
    "idf_sampling": dict(idf_sampling=1.0),
    "default": dict(),
}


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def dense_teacher(texts):
    """A deterministic custom mining teacher (``teacher_score_fn``)."""
    def score(queries):
        return np.asarray([[len(set(q) & set(t)) / (1.0 + len(t)) for t in texts]
                           for q in queries], np.float32)
    return score


@pytest.mark.parametrize("mode", list(MODES) + ["custom_teacher"])
def test_pair_sampler_draws_equal_jax(mode):
    kw = MODES.get(mode, dict(hard_batch_prob=0.5))
    common = dict(batch_size=8, min_span=4, seed=0, **kw)
    teacher = dense_teacher(CORPUS) if mode == "custom_teacher" else None
    js = JP.PairSampler(CORPUS, JP.PretrainConfig(**common), teacher_score_fn=teacher)
    ts = TP.PairSampler(CORPUS, TP.PretrainConfig(**common), teacher_score_fn=teacher,
                        device="cpu")
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(20):
        jq, jp, jt = js.sample(jr)
        tq, tp, tt = ts.sample(tr)
        assert (tq, tp) == (jq, jp), (mode, i)
        if jt is None:
            assert tt is None
        else:
            assert tt.dtype == jt.dtype and np.array_equal(tt, jt), (mode, i)
    assert jr.random() == tr.random()             # the streams stayed in step


def test_pretrain_config_and_constants_match_jax():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(TP.PretrainConfig) == spec(JP.PretrainConfig)
    assert TP._QUESTION_FRAMES == JP._QUESTION_FRAMES
    assert TP._ALIAS_RE.pattern == JP._ALIAS_RE.pattern
    assert TP._TERM_PREFIX_RE.pattern == JP._TERM_PREFIX_RE.pattern
    assert TP._JUNK_ALIASES == JP._JUNK_ALIASES


def test_pair_helpers_equal_jax():
    assert TP.mine_alias_pairs(CORPUS) == JP.mine_alias_pairs(CORPUS)
    assert ("营业收入", "营收") in TP.mine_alias_pairs(CORPUS)
    for kw in (dict(), dict(crop_prob=1.0), dict(crop_prob=0.0, keep_span_prob=1.0)):
        got = TP.contrastive_pairs(CORPUS, 24, np.random.default_rng(2), **kw)
        assert got == JP.contrastive_pairs(CORPUS, 24, np.random.default_rng(2), **kw)
    assert TP.ict_pairs(CORPUS, 16, np.random.default_rng(4)) == \
        JP.ict_pairs(CORPUS, 16, np.random.default_rng(4))
    with pytest.raises(ValueError, match="long enough"):
        TP.PairSampler(["短"], TP.PretrainConfig(), device="cpu")


QUERIES = [t[:12] for t in CORPUS[:6]] + ["营收情况如何", "钠离子 储热", "无关的词"]


def test_host_scorer_bitwise_equal_jax():
    from rag_challenge_2_tpu.ops.bm25 import HostBM25Scorer as JaxScorer
    from rag_challenge_2_tpu.ops.bm25 import encode_queries_host as jax_encode
    from rag_challenge_2_tpu_torch.ops.bm25 import HostBM25Scorer, encode_queries_host

    cfg = TP.PretrainConfig(batch_size=4, min_span=4)
    js = JP.PairSampler(CORPUS, JP.PretrainConfig(batch_size=4, min_span=4))
    ts = TP.PairSampler(CORPUS, cfg, device="cpu")
    assert ts._host_scorer is not None and ts._n_pad == js._n_pad
    qt = encode_queries_host(QUERIES, max_terms=48, vocab_bits=cfg.bm25_vocab_bits)
    np.testing.assert_array_equal(qt, jax_encode(QUERIES, 48, cfg.bm25_vocab_bits))
    got = HostBM25Scorer(ts._sparse).scores(qt, ts._n_pad)
    want = JaxScorer(js._sparse).scores(qt, js._n_pad)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0
    empty = np.full((2, 48), -1, np.int32)
    assert ts._host_scorer.scores(empty, ts._n_pad).sum() == 0.0


def test_device_teacher_matches_host_teacher():
    """``host_teacher=False``: the CSR lives on the given device and the
    teacher is ``bm25_scores`` (kernel K2 on a card; its plain version on
    the CPU)."""
    host = TP.PairSampler(CORPUS, TP.PretrainConfig(batch_size=4, min_span=4),
                          device="cpu")
    dev = TP.PairSampler(CORPUS, TP.PretrainConfig(batch_size=4, min_span=4,
                                                   host_teacher=False), device="cpu")
    assert dev._host_scorer is None and dev._sparse.indptr.device.type == "cpu"
    a, b = dev._teacher_scores(QUERIES), host._teacher_scores(QUERIES)
    assert a.shape == b.shape == (len(QUERIES), len(CORPUS))
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def _twin_start(seed=2):
    jm = JaxModel(JaxCfg(**SMALL, dtype=jnp.float32), seed=seed)
    return jm.params, from_jax_params(flat(jm.params))


def test_pretrain_trajectory_matches_jax():
    """10 steps of the default recipe (BM25 distillation, hard batches,
    alias swaps through the host teacher) from the same weights."""
    jparams, tparams = _twin_start()
    pre = dict(steps=10, batch_size=8, min_span=4, seed=1)
    _, jinfo = JP.pretrain_encoder(
        CORPUS, enc_cfg=JaxCfg(**SMALL, dtype=jnp.float32),
        pre_cfg=JP.PretrainConfig(**pre), train_cfg=JaxTrainConfig(lr=3e-3),
        log_every=1, init_params=jparams)
    _, tinfo = TP.pretrain_encoder(
        CORPUS, enc_cfg=EncoderConfig(**SMALL, dtype=torch.float32),
        pre_cfg=TP.PretrainConfig(**pre), train_cfg=TrainConfig(lr=3e-3),
        device="cpu", log_every=1, init_params=tparams)
    jh, th = jinfo["history"], tinfo["history"]
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(10))
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh],
                               rtol=2e-3)
    np.testing.assert_allclose([h["accuracy"] for h in th],
                               [h["accuracy"] for h in jh], atol=1 / 8 + 1e-6)
    assert tinfo["final"] == th[-1]


def _tiny_run(**kw):
    cfg = dict(steps=7, batch_size=8, min_span=4)
    cfg.update(kw)
    return TP.pretrain_encoder(
        CORPUS, enc_cfg=EncoderConfig(**SMALL), device="cpu", log_every=2,
        pre_cfg=TP.PretrainConfig(**cfg))


def test_steps_per_dispatch_keeps_the_trajectory():
    """K only sets how many steps' metrics are read at once: 1 and 3 (which
    does not divide 7) give the same weights and history, bitwise."""
    (m1, h1), (m3, h3) = _tiny_run(steps_per_dispatch=1), _tiny_run(steps_per_dispatch=3)
    assert h1 == h3 and [h["step"] for h in h1["history"]] == [0, 2, 4, 6]
    for (n1, a), (n3, b) in zip(m1.module.state_dict().items(),
                                m3.module.state_dict().items()):
        assert n1 == n3 and torch.equal(a, b), n1


def test_warm_start_continues_from_init_params():
    m1, _ = _tiny_run(steps=3)
    same, info0 = TP.pretrain_encoder(
        CORPUS, enc_cfg=EncoderConfig(**SMALL), device="cpu",
        pre_cfg=TP.PretrainConfig(steps=0, batch_size=8, min_span=4),
        init_params=m1.module.state_dict())
    assert info0 == {"history": [], "final": {}}
    for (n, a), (_, b) in zip(m1.module.state_dict().items(),
                              same.module.state_dict().items()):
        assert torch.equal(a, b), n
    m2, info = TP.pretrain_encoder(
        CORPUS, enc_cfg=EncoderConfig(**SMALL), device="cpu",
        pre_cfg=TP.PretrainConfig(steps=2, batch_size=8, min_span=4, seed=3),
        train_cfg=TrainConfig(lr=3e-4, total_steps=2),
        init_params=m1.module.state_dict())
    assert np.isfinite(info["final"]["loss"])
    moved = [n for (n, a), (_, b) in zip(m1.module.state_dict().items(),
                                         m2.module.state_dict().items())
             if not torch.equal(a, b)]
    assert moved                  # the second update (lr > 0) moved weights


def test_params_round_trips_both_ways(tmp_path):
    """port save → JAX load_params → JAX save → port load, and the reverse:
    every array bitwise, and the JAX model embeds with the port's weights."""
    jm = JaxModel(JaxCfg(**SMALL), seed=7)
    JP.save_params(jm, tmp_path / "jax.npz")
    tm = TP.load_params(EmbeddingModel(EncoderConfig(**SMALL), device="cpu"),
                        tmp_path / "jax.npz")
    TP.save_params(tm, tmp_path / "port.npz")
    a, b = load_params_npz(tmp_path / "jax.npz"), load_params_npz(tmp_path / "port.npz")
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k

    m, _ = _tiny_run(steps=2)
    TP.save_params(m, tmp_path / "trained.npz")
    jm2 = JP.load_params(JaxModel(JaxCfg(**SMALL)), tmp_path / "trained.npz")
    JP.save_params(jm2, tmp_path / "back.npz")
    back = TP.load_params(EmbeddingModel(EncoderConfig(**SMALL), device="cpu"),
                          tmp_path / "back.npz")
    for (n, x), (_, y) in zip(m.module.state_dict().items(),
                              back.module.state_dict().items()):
        assert torch.equal(x, y), n
    texts = ["营业收入 增长", "净利润"]
    e_t, e_j = m.embed(texts), np.asarray(jm2.embed(texts))
    cos = (e_t * e_j).sum(1)
    assert cos.min() >= 0.999, cos
    with pytest.raises(ValueError, match="no"):
        TP.load_params(EmbeddingModel(EncoderConfig(**{**SMALL, "d_model": 64}),
                                      device="cpu"), tmp_path / "trained.npz")


def test_ensemble_teacher_matches_jax():
    """BM25 + a dense model's scores, each max-normalised: the port's
    (BM25 through ``bm25_scores``) against the JAX package's on the same
    f32 weights, within 1e-4."""
    jm = JaxModel(JaxCfg(**SMALL, dtype=jnp.float32), seed=1)
    tm = EmbeddingModel(EncoderConfig(**SMALL, dtype=torch.float32),
                        params=from_jax_params(flat(jm.params)), device="cpu")
    got = TP.ensemble_teacher(CORPUS, tm, alpha=0.6)(QUERIES)
    want = JP.ensemble_teacher(CORPUS, jm, alpha=0.6)(QUERIES)
    assert got.shape == want.shape == (len(QUERIES), len(CORPUS))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
