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


# ---- K1's planner (pure Python: the grid each call launches) ---------------

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from rag_challenge_2_tpu_torch.ops.dense_topk import plan as k1_plan  # noqa: E402
from rag_challenge_2_tpu_torch.ops import float_scan as fs  # noqa: E402


def check_float_plan(p, B, N, k, elt, sms):
    """What every scan_float plan must satisfy: the tile holds the batch,
    the chunks cover each row exactly once in one store pass, the grid
    fits the card, and the stage ring fits the shared memory."""
    tq, qg, tr = fs.TILES[p.query_tile]
    assert p.query_tile >= B
    assert all(t < B for t in fs.TILES if t < p.query_tile)     # the smallest tile
    assert p.tile_rows == fs.tile_rows(p.query_tile) == 32 * tr * 8 // qg
    assert tq * qg == p.query_tile
    assert p.store_passes == 1
    assert p.rows_per_chunk >= 1
    assert (p.n_chunks - 1) * p.rows_per_chunk < N <= p.n_chunks * p.rows_per_chunk
    assert p.n_chunks <= p.blocks_per_sm * sms and p.blocks_per_sm in (1, 2)
    if p.blocks_per_sm == 2:
        assert tq * tr <= 16                                     # <= 128 registers
    # a stage brings whole tiles, or the one small tile of a small chunk
    assert p.box_rows % 8 == 0 and 8 <= p.box_rows <= p.tile_rows
    if p.box_rows < p.tile_rows:
        assert p.rows_per_chunk <= p.box_rows
    else:
        assert p.rows_per_chunk % p.tile_rows == 0 or p.rows_per_chunk <= p.tile_rows
    assert p.box_rows <= fs.MAX_BOX_ROWS or p.box_rows % fs.MAX_BOX_ROWS == 0
    assert 2 <= p.stages <= fs.MAX_STAGES
    stage, total = fs.smem_bytes(p.query_tile, p.tile_rows, elt, min(k, N), p.stages)
    assert total == p.smem and stage % 1024 == 0
    budget = 227 * 1024 if p.blocks_per_sm == 1 else 228 * 1024 // 2 - 1024
    assert p.smem <= budget
    # one more stage would not fit (or the ring is at its cap)
    assert p.stages == fs.MAX_STAGES or p.smem + stage > budget


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 64), N=st.one_of(st.integers(1, 5000), st.integers(1, 3_000_000)),
       k=st.integers(1, 64), bf16=st.booleans(), sms=st.sampled_from([108, 132]))
def test_k1_plan_sweep(B, N, k, bf16, sms):
    """Chunk rows, query tile, stages and shared memory of every K1 call:
    each row covered exactly once, one store pass at any batch."""
    p = k1_plan(B, N, k, bf16, sms)
    assert p.query_tile <= 64
    check_float_plan(p, B, N, k, 2 if bf16 else 4, sms)


@pytest.mark.parametrize("B", [1, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("N,bf16", [(10_240, False), (250_000, False), (250_000, True),
                                    (1_500_000, True)])
def test_k1_plan_fills_the_card_at_the_main_path_shapes(B, N, bf16):
    """The deployment's 10,240 rows spread over (nearly) every SM in chunks
    smaller than a tile; the large stores run whole tiles on a persistent
    grid.  The store is read once whatever the batch."""
    p = k1_plan(B, N, 30, bf16, 132)
    assert p.store_passes == 1 and p.query_tile == max(8, B)
    assert p.n_chunks >= 0.6 * 132
    if N == 10_240:
        assert p.box_rows == p.rows_per_chunk < p.tile_rows
    else:
        assert p.box_rows == p.tile_rows


def test_k1_plan_rejects_more_than_64_queries():
    with pytest.raises(ValueError):
        k1_plan(65, 1000, 10, False, 132)
    with pytest.raises(ValueError):
        k1_plan(0, 1000, 10, False, 132)


def test_kernel_libraries_rebuild_when_a_shared_header_changes(tmp_path, monkeypatch):
    """K1 and K3 include ``float_scan.cuh``; a library older than a header
    its source includes is stale."""
    import os

    from rag_challenge_2_tpu_torch.utils import kernels

    for name in ("dense_topk", "stream_topk"):
        files = [f.name for f in kernels.source_files(kernels.CSRC / f"{name}.cu")]
        assert files[0] == f"{name}.cu" and "float_scan.cuh" in files
    assert [f.name for f in kernels.source_files(kernels.CSRC / "span_gather.cu")] == [
        "span_gather.cu"]
    # a copy of the sources with a fresh library: touching the header alone
    # makes _build want nvcc again
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "b.cuh"\n')
    (csrc / "b.cuh").write_text('#  include "c.cuh"\n')
    (csrc / "c.cuh").write_text("// leaf\n")
    build = tmp_path / "build"
    build.mkdir()
    lib = build / "liba.so"
    lib.write_text("")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    now = lib.stat().st_mtime
    for f in csrc.iterdir():
        os.utime(f, (now - 10, now - 10))
    assert kernels._build("a") == lib                       # fresh: no nvcc
    os.utime(csrc / "c.cuh", (now + 10, now + 10))
    monkeypatch.setattr(kernels, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc wanted")))
    with pytest.raises(RuntimeError, match="nvcc wanted"):
        kernels._build("a")
