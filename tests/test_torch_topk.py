"""Dense top-k: the plain PyTorch version of kernel K1 against the JAX
package's XLA path and its Pallas kernel (interpret mode on the CPU).

Values agree within 1e-5: both sides are full-f32 products, summed in
different orders.  Rows agree exactly wherever the values are not tied
within that tolerance; exact ties go to the lowest row on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.ops.pallas_topk import pallas_dense_topk
from rag_challenge_2_tpu.ops.topk import dense_topk as jax_dense_topk
from rag_challenge_2_tpu_torch.ops.dense_topk import dense_topk_fused, dense_topk_plain
from rag_challenge_2_tpu_torch.ops.topk import NEG_INF, dense_topk

TOL = 1e-5


def assert_same_topk(tv, ti, jv, ji, tol=TOL):
    tv, ti = tv.numpy(), ti.numpy()
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert tv.shape == jv.shape and ti.dtype == np.int32
    np.testing.assert_allclose(tv, jv, rtol=tol, atol=tol)
    for b in range(tv.shape[0]):
        v = jv[b]
        gap = np.minimum(np.abs(np.diff(v, prepend=np.inf)),
                         np.abs(np.diff(v, append=-np.inf)))
        untied = gap > 2 * tol
        np.testing.assert_array_equal(ti[b][untied], ji[b][untied])
        # near-tied positions hold the same set of rows
        assert set(ti[b][~untied]) == set(ji[b][~untied])


@pytest.mark.parametrize("B,N,D,k,tile", [(4, 2048, 128, 16, 512),
                                          (2, 1500, 64, 7, 256)])
def test_plain_matches_xla_and_pallas(rng, B, N, D, k, tile):
    q = rng.normal(size=(B, D)).astype(np.float32)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    mask = rng.random(N) > 0.2
    tv, ti = dense_topk_plain(torch.from_numpy(q), torch.from_numpy(emb), k,
                              torch.from_numpy(mask))
    xv, xi = jax_dense_topk(jnp.asarray(q), jnp.asarray(emb), k,
                            mask=jnp.asarray(mask), impl="xla")
    pv, pi = pallas_dense_topk(jnp.asarray(q), jnp.asarray(emb), k,
                               jnp.asarray(mask), tile_n=tile)
    assert_same_topk(tv, ti, xv, xi)
    assert_same_topk(tv, ti, pv, pi)
    assert mask[ti.numpy()].all()


def test_ties_go_to_lowest_row(rng):
    base = rng.normal(size=(40, 32)).astype(np.float32)
    emb = np.concatenate([base, base, base[::-1]])         # every row 3x
    q = rng.normal(size=(3, 32)).astype(np.float32)
    tv, ti = dense_topk(torch.from_numpy(q), torch.from_numpy(emb), 12)
    xv, xi = jax_dense_topk(jnp.asarray(q), jnp.asarray(emb), 12, impl="xla")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    np.testing.assert_allclose(tv.numpy(), np.asarray(xv), rtol=TOL, atol=TOL)
    # each value appears three times, rows ascending within the tie
    for b in range(3):
        rows = ti[b].numpy().reshape(4, 3)
        assert (np.diff(rows, axis=1) > 0).all()


def test_k_larger_than_n(rng):
    q = rng.normal(size=(2, 16)).astype(np.float32)
    emb = rng.normal(size=(8, 16)).astype(np.float32)
    tv, ti = dense_topk(torch.from_numpy(q), torch.from_numpy(emb), 20)
    xv, xi = jax_dense_topk(jnp.asarray(q), jnp.asarray(emb), 20, impl="xla")
    assert tv.shape == (2, 8)
    assert_same_topk(tv, ti, xv, xi)


def test_all_masked_gives_neg_inf_and_lowest_rows(rng):
    q = rng.normal(size=(2, 16)).astype(np.float32)
    emb = rng.normal(size=(50, 16)).astype(np.float32)
    mask = np.zeros(50, bool)
    tv, ti = dense_topk(torch.from_numpy(q), torch.from_numpy(emb), 5,
                        torch.from_numpy(mask))
    xv, xi = jax_dense_topk(jnp.asarray(q), jnp.asarray(emb), 5,
                            mask=jnp.asarray(mask), impl="xla")
    assert (tv.numpy() == np.float32(NEG_INF)).all()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(xv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))


def test_bf16_store_with_f32_queries(rng):
    """f32 queries against a bf16 store score in f32, like the engine."""
    q = rng.normal(size=(4, 64)).astype(np.float32)
    emb = rng.normal(size=(600, 64)).astype(np.float32)
    mask = rng.random(600) > 0.3
    emb_t = torch.from_numpy(emb).to(torch.bfloat16)
    tv, ti = dense_topk(torch.from_numpy(q), emb_t, 9, torch.from_numpy(mask))
    xv, xi = jax_dense_topk(jnp.asarray(q), jnp.asarray(emb, jnp.bfloat16), 9,
                            mask=jnp.asarray(mask), impl="xla")
    assert_same_topk(tv, ti, xv, xi)


def test_wrapper_never_falls_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises."""
    q = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        dense_topk_fused(q, torch.zeros((4, 8), device="meta"), 2)
