"""Data-parallel pretraining (``models/pretrain.pretrain_encoder(mesh=)``,
``parallel/pretrain.pretrain_data_parallel``) in gloo worlds on the CPU,
against the JAX package's ``pretrain_encoder(mesh=...)`` on its CPU mesh
and against the port's own single-device loop.  Rank programs are in
``tests/torch_train_ranks.py``; every world starts from the same
flax-initialised weights (``from_jax_params``), f32 activations, the
small config.

Tolerances: against JAX (``data 2``, 10 steps, the host teacher), the loss
within 2e-3 relative and the accuracy within one example of 8, as the
single-device loop is held (``tests/test_torch_pretrain.py``).  Against
the port's single device (``data 2``, ``data 2 x model 2``, ``data 1 x
pipe 2``): the loss within 1e-5 relative at every step (measured: at most
3.4e-7, 1.1e-6 and 4.6e-7; the ranks sum the gradients and the model
shards' partial products in another order), the accuracy equal, and 8
chunks' embeddings at cosine >= 0.99999 (measured: 0.9999999).  The
weights are not held element by element: Adam moves an element whose
gradient's sign is rounding by about twice the learning rate (measured:
5.1e-3 at most, lr 3e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rag_challenge_2_tpu.models.pretrain as JP
import rag_challenge_2_tpu_torch.models.pretrain as TP
from rag_challenge_2_tpu.models.encoder import EmbeddingModel as JaxModel
from rag_challenge_2_tpu.models.encoder import EncoderConfig as JaxCfg
from rag_challenge_2_tpu.models.train import TrainConfig as JaxTrainConfig
from rag_challenge_2_tpu.parallel.mesh import make_mesh as jax_mesh
from rag_challenge_2_tpu_torch.models.encoder import (
    EmbeddingModel, EncoderConfig, from_jax_params)
from rag_challenge_2_tpu_torch.models.train import TrainConfig
from rag_challenge_2_tpu_torch.parallel.launch import run_ranks
from rag_challenge_2_tpu_torch.parallel.pretrain import pretrain_data_parallel
from tests import torch_train_ranks as R
from tests.test_torch_chunked_step import SMALL, flat
from tests.test_torch_pretrain import CORPUS

PRE = dict(steps=10, batch_size=8, min_span=4, seed=1)
CFG = EncoderConfig(**SMALL, dtype=torch.float32)
TC = TrainConfig(lr=3e-3)


@pytest.fixture(scope="module")
def start():
    """The JAX package's initial weights and the port's copy of them."""
    jm = JaxModel(JaxCfg(**SMALL, dtype=jnp.float32), seed=2)
    return jm.params, from_jax_params(flat(jm.params))


def single(start, **pre):
    return TP.pretrain_encoder(CORPUS, enc_cfg=CFG, pre_cfg=TP.PretrainConfig(**pre),
                               train_cfg=TC, device="cpu", log_every=1,
                               init_params=start[1])


@pytest.fixture(scope="module")
def data2(start):
    """``pretrain_data_parallel`` over 2 ranks, in chunks of 4 (4, 4, 2)."""
    return pretrain_data_parallel(
        CORPUS, 2, "gloo", "cpu", timeout=300, enc_cfg=CFG,
        pre_cfg=TP.PretrainConfig(**PRE, steps_per_dispatch=4), train_cfg=TC,
        log_every=1, init_params=start[1])


def losses(info):
    assert [h["step"] for h in info["history"]] == list(range(PRE["steps"]))
    return np.array([h["loss"] for h in info["history"]])


def test_data_parallel_matches_jax_data_parallel(start, data2):
    _, jinfo = JP.pretrain_encoder(
        CORPUS, enc_cfg=JaxCfg(**SMALL, dtype=jnp.float32), pre_cfg=JP.PretrainConfig(**PRE),
        train_cfg=JaxTrainConfig(lr=3e-3), mesh=jax_mesh({"data": 2, "model": 1}),
        log_every=1, init_params=start[0])
    model, info = data2
    assert isinstance(model, EmbeddingModel) and model.device.type == "cpu"
    np.testing.assert_allclose(losses(info), losses(jinfo), rtol=2e-3)
    np.testing.assert_allclose([h["accuracy"] for h in info["history"]],
                               [h["accuracy"] for h in jinfo["history"]], atol=1 / 8 + 1e-6)
    assert info["final"] == info["history"][-1]


def same_trajectory(model, info, start, **pre):
    """A world's run against the single device's (module docstring)."""
    ref, ref_info = single(start, **pre)
    np.testing.assert_allclose(losses(info), losses(ref_info), rtol=1e-5)
    assert [h["accuracy"] for h in info["history"]] == \
        [h["accuracy"] for h in ref_info["history"]]
    cos = (model.embed(CORPUS[:8]) * ref.embed(CORPUS[:8])).sum(1)
    assert cos.min() >= 0.99999, cos


def test_data_parallel_matches_the_single_device(start, data2):
    same_trajectory(*data2, start, **PRE)


@pytest.mark.parametrize("axes", [{"data": 2, "model": 2}, {"data": 1, "pipe": 2}],
                         ids=["data2_model2", "data1_pipe2"])
def test_meshes_return_whole_weights(start, axes):
    """Every rank returns the whole weights (its ``model`` shards gathered,
    its shards their split) and the same history; only rank 0 samples,
    with the device teacher (``host_teacher=False``: ``bm25_scores``, K2's
    plain version here); the trajectory follows the single device's."""
    pre = dict(PRE, host_teacher=False, steps_per_dispatch=3)
    kw = dict(enc_cfg=CFG, pre_cfg=TP.PretrainConfig(**pre), train_cfg=TC, log_every=1,
              init_params={k: v.numpy() for k, v in start[1].items()})
    world = int(np.prod(list(axes.values())))
    r = run_ranks(R.pretrain_world, world, "gloo", "cpu", (CORPUS, axes, kw), timeout=300)
    every = r["every"]
    assert all(e["gathered"] and e["split"] for e in every)
    assert all(e["history"] == every[0]["history"] == r["info"]["history"] for e in every)
    assert len({e["digest"] for e in every}) == 1
    d_model = SMALL["d_model"]
    split = "model" in axes
    assert every[0]["shapes"]["tok_embed"][1] == (d_model // 2 if split else d_model)
    assert [e["samplers"] for e in every] == [[(True, "cpu")]] + [[]] * (world - 1)
    assert every[0]["teacher_calls"] > 0 and all(e["teacher_calls"] == 0 for e in every[1:])
    got = EmbeddingModel(CFG, params={k: torch.from_numpy(v) for k, v in r["whole"].items()},
                         device="cpu")
    same_trajectory(got, r["info"], start, **pre)


def test_a_batch_that_does_not_divide_over_data_raises():
    with pytest.raises(RuntimeError, match="a batch of 7 rows does not divide over 2 data"):
        pretrain_data_parallel(CORPUS, 2, "gloo", "cpu", timeout=120, enc_cfg=CFG,
                               pre_cfg=TP.PretrainConfig(**dict(PRE, batch_size=7)),
                               train_cfg=TC)


def test_more_than_one_card_trains_over_every_card(monkeypatch):
    """``pretrain_encoder(mesh=None)`` on the card with more than one card
    visible hands the run to ``pretrain_data_parallel`` over every card
    (NCCL), as the JAX package's default mesh spans every device; its
    keywords travel unchanged."""
    import rag_challenge_2_tpu_torch.parallel.pretrain as PP

    calls = []
    monkeypatch.setattr(PP, "pretrain_data_parallel",
                        lambda *a, **kw: calls.append((a, kw)) or ("model", "info"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    pre = TP.PretrainConfig(**PRE)
    assert TP.pretrain_encoder(CORPUS, enc_cfg=CFG, pre_cfg=pre, train_cfg=TC,
                               device="cuda", log_every=7) == ("model", "info")
    (args, kw), = calls
    assert args[1:] == (3, "nccl", "cuda") and args[0] is CORPUS
    assert kw == dict(enc_cfg=CFG, pre_cfg=pre, train_cfg=TC, log_every=7,
                      teacher_score_fn=None, init_params=None)
