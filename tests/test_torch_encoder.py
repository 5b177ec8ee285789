"""The encoder port against the flax encoder at a small config, with the
same (flax-initialised) weights carried over by ``from_jax_params``.

Activations are bf16 on both sides and round at different places (flax
rounds each op's output, torch's CPU kernels accumulate some in f32), so
the unit-norm embeddings agree to a per-row cosine of at least 0.999 and
a max abs diff of at most 0.02, not bitwise."""

import jax
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.models.encoder import EmbeddingModel as JaxModel
from rag_challenge_2_tpu.models.encoder import EncoderConfig as JaxCfg
from rag_challenge_2_tpu.models.encoder import tokenize_batch as jax_tokenize
from rag_challenge_2_tpu.models.pretrain import save_params
from rag_challenge_2_tpu_torch.models.encoder import (
    EmbeddingModel, EncoderConfig, from_jax_params, load_params_npz,
    tokenize_batch)

SMALL = dict(vocab_bits=10, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_len=64, out_dim=64)
TEXTS = [
    "金盘科技2023年营业收入为66.68亿元，同比增长40.87%",
    "hello world",
    "",                                                   # empty → all padding
    "储能 " * 40,                                          # fills max_len
    "宁德时代 净利润 研发投入 2024年",
]


def _flat(params):
    return {
        "/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(params)[0]
    }


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(JaxCfg(**SMALL), seed=3)
    tm = EmbeddingModel(EncoderConfig(**SMALL), params=from_jax_params(
        _flat(jm.params)), device="cpu")
    return jm, tm


EMPTY = TEXTS.index("")


def _assert_close(a, b):
    # the empty text pools to zero features: its embedding is the
    # normalized projection bias, zero at initialisation on both sides
    np.testing.assert_array_equal(a[EMPTY], b[EMPTY])
    a, b = np.delete(a, EMPTY, 0), np.delete(b, EMPTY, 0)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert cos.min() >= 0.999, cos
    assert np.abs(a - b).max() <= 0.02


def test_tokenize_batch_matches_jax():
    for bucket in (False, True):
        np.testing.assert_array_equal(
            tokenize_batch(TEXTS, 64, 10, bucket_len=bucket),
            jax_tokenize(TEXTS, 64, 10, bucket_len=bucket))


def test_embeddings_match_flax(models):
    jm, tm = models
    ids = tokenize_batch(TEXTS, 64, 10)
    assert (ids[2] == -1).all() and (ids[3] >= 0).all()
    j = np.asarray(jm.embed_tokens(jax.numpy.asarray(ids)))
    t = tm.embed_tokens(torch.from_numpy(ids)).numpy()
    assert t.shape == (len(TEXTS), 64) and t.dtype == np.float32
    np.testing.assert_allclose(
        np.linalg.norm(np.delete(t, EMPTY, 0), axis=1), 1.0, rtol=1e-5)
    _assert_close(t, j)


def test_embed_matches_flax_embed(models):
    """The batched host API (length bucketing, batch splits) agrees too."""
    jm, tm = models
    _assert_close(tm.embed(TEXTS, batch_size=2), jm.embed(TEXTS, batch_size=2))
    assert tm.embed_device(TEXTS[:2]).device.type == "cpu"


def test_params_npz_round_trip(models, tmp_path):
    jm, tm = models
    save_params(jm, tmp_path / "enc.npz")
    flat = load_params_npz(tmp_path / "enc.npz")
    assert set(flat) == set(_flat(jm.params))
    tm2 = EmbeddingModel(EncoderConfig(**SMALL), params=from_jax_params(flat),
                         device="cpu")
    for (n1, p1), (n2, p2) in zip(tm.module.state_dict().items(),
                                  tm2.module.state_dict().items()):
        assert n1 == n2 and torch.equal(p1, p2), n1


def test_seeded_random_weights_are_reproducible():
    cfg = EncoderConfig(**SMALL)
    a = EmbeddingModel(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(5)).embed(TEXTS)
    b = EmbeddingModel(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(5)).embed(TEXTS)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        np.linalg.norm(np.delete(a, EMPTY, 0), axis=1), 1.0, rtol=1e-5)
