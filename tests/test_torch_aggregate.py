"""Hit fusion: the port's ``fuse_hits`` against the JAX package's on random
hit lists with tied similarities, invalid slots and keys near 2**30.

key, n_queries, n_methods and rep_row must be exact.  Max-mode scores are
the same f32 products of the same values, so they must agree to 1e-6.
Sum-mode scores add each method's best hit; the reference adds them
through an f32 cumsum difference over the whole hit list, which is off by
a few ulps of the running total, so sum mode compares at 4 f32 ulps of
that total."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.ops.aggregate import fuse_hits as jax_fuse
from rag_challenge_2_tpu_torch.ops.aggregate import fuse_hits

FIELDS = ("key", "n_queries", "n_methods", "rep_row")


def _hits(rng, L, n_keys, big_keys):
    keys = rng.integers(0, n_keys, L).astype(np.int32)
    if big_keys:
        keys = (keys + (2**30 - n_keys - 1)).astype(np.int32)
    # a coarse grid of similarities → many exact ties
    sims = (rng.integers(-4, 20, L) / 16.0).astype(np.float32)
    qid = rng.integers(0, 8, L).astype(np.int32)
    mid = rng.choice([0, 3], L).astype(np.int32)
    row = rng.integers(0, 5000, L).astype(np.int32)
    valid = rng.random(L) > 0.2
    return keys, sims, qid, mid, row, valid


def _run(hits, top_n, mode):
    j = jax_fuse(*(jnp.asarray(h) for h in hits), top_n=top_n, mode=mode)
    t = fuse_hits(*(torch.from_numpy(h) for h in hits), top_n=top_n, mode=mode)
    return j, t


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("big_keys", [False, True])
def test_max_mode_matches_jax(seed, big_keys):
    rng = np.random.default_rng(seed)
    hits = _hits(rng, 480, 60, big_keys)
    j, t = _run(hits, 30, "max")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("score", "base_sim"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("big_keys", [False, True])
def test_sum_mode_matches_jax(seed, big_keys):
    rng = np.random.default_rng(seed)
    hits = _hits(rng, 480, 60, big_keys)
    # continuous sims: the reference's cumsum rounding must not decide order
    hits = (hits[0], rng.random(480).astype(np.float32), *hits[2:])
    j, t = _run(hits, 30, "sum")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    total = float(np.clip(hits[1][hits[5]], 0, None).sum())
    tol = 4 * np.finfo(np.float32).eps * total
    np.testing.assert_allclose(t.score.numpy(), np.asarray(j.score),
                               rtol=1e-6, atol=tol)
    np.testing.assert_allclose(t.base_sim.numpy(), np.asarray(j.base_sim),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["max", "sum"])
def test_fewer_keys_than_top_n_and_all_invalid(mode):
    rng = np.random.default_rng(9)
    hits = list(_hits(rng, 40, 5, False))
    j, t = _run(tuple(hits), 30, mode)
    assert t.key.shape == (30,) and (t.key.numpy()[5:] == -1).all()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    hits[5] = np.zeros(40, bool)
    j, t = _run(tuple(hits), 10, mode)
    assert (t.key.numpy() == -1).all() and (t.score.numpy() == 0).all()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


def test_rep_row_ties_keep_the_larger_row():
    key = np.array([7, 7, 7, 3], np.int32)
    sim = np.array([0.5, 0.9, 0.9, 0.2], np.float32)
    qid = np.array([0, 1, 2, 0], np.int32)
    mid = np.zeros(4, np.int32)
    row = np.array([10, 4, 12, 1], np.int32)
    valid = np.ones(4, bool)
    t = fuse_hits(*(torch.from_numpy(a) for a in (key, sim, qid, mid, row, valid)),
                  top_n=4)
    assert t.key.tolist()[:2] == [7, 3]
    assert t.rep_row.tolist()[:2] == [12, 1]
    assert t.n_queries.tolist()[:2] == [3, 1]
    np.testing.assert_allclose(t.score[0].item(), 0.9 * 1.4, rtol=1e-6)
