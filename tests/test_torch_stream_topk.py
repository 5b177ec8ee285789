"""The streaming scan (kernel K3's plain version) and the bounded-memory
top-k family of ``ops/topk.py`` against the JAX package on the CPU.

Inputs are unit rows made with numpy from a seed.  f32 / bf16 values agree
within 1e-5 (f32 products summed in another order than XLA's CPU dot).
int8 values agree within 1e-5 too, not bitwise: inside a jitted function
XLA rewrites the query scale ``amax / 127`` as ``amax * (1 / 127)`` and
contracts the 2-pass residual ``q - q_hi * s_hi`` into an FMA, so its
query codes and scales can differ from the eager arithmetic in the last
bit (``test_torch_quant`` holds the eager functions bitwise).  Rows are
compared with ``assert_same_topk``: equal wherever values are not tied
within the tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.ops import quant as jq
from rag_challenge_2_tpu.ops import topk as jt
from rag_challenge_2_tpu.ops.pallas_topk_stream import stream_dense_topk as jax_stream
from rag_challenge_2_tpu_torch.ops import quant as tq
from rag_challenge_2_tpu_torch.ops import topk as tt
from rag_challenge_2_tpu_torch.ops.stream_topk import (
    stream_dense_topk, stream_topk, stream_topk_plain)
from tests.test_torch_topk import assert_same_topk

TOL = 1e-5


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _data(rng, B, N, D, n_codes=24):
    """Clustered unit rows (near ties occur), queries near corpus rows,
    and the codebook the rows were drawn around."""
    cent = _unit(rng.normal(size=(n_codes, D)))
    x = _unit(cent[rng.integers(0, n_codes, N)] + 0.4 * rng.normal(size=(N, D)))
    q = _unit(x[rng.integers(0, N, B)] + 0.05 * rng.normal(size=(B, D)))
    return q, x, cent


T = torch.from_numpy


# ---- K3 under the JAX name: stream_dense_topk -----------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,D,k,tile", [(4, 1500, 64, 10, 512),
                                          (3, 700, 32, 30, 256),
                                          (1, 64, 16, 64, 64)])
def test_stream_dense_topk_matches_pallas_interpret(rng, dtype, B, N, D, k, tile):
    q, x, _ = _data(rng, B, N, D)
    mask = rng.random(N) > 0.3
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jv, ji = jax_stream(jnp.asarray(q), jnp.asarray(x, dtype), k,
                        jnp.asarray(mask), tile_n=tile, interpret=True)
    tv, ti = stream_dense_topk(T(q), T(x).to(tdt), k, T(mask))
    assert_same_topk(tv, ti, jv, ji)
    assert mask[ti.numpy()[ti.numpy() >= 0]].all()


def test_stream_dense_topk_overflow_and_float_mask(rng):
    """Fewer eligible rows than k: NEG_INF past them.  The Pallas merge
    leaves whatever row sat in its first column in those slots (the
    overflow trap: compare by value); the port writes row -1 there, as
    ``blocked_topk`` does.  The mask may be a float array (> 0)."""
    q, x, _ = _data(rng, 3, 300, 32)
    mask = np.zeros(300, np.float32)
    mask[[3, 150, 299]] = 1.0
    jv, ji = jax_stream(jnp.asarray(q), jnp.asarray(x), 8, jnp.asarray(mask),
                        tile_n=128, interpret=True)
    tv, ti = stream_dense_topk(T(q), T(x), 8, T(mask))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ti.numpy()[:, :3], np.asarray(ji)[:, :3])
    assert (ti.numpy()[:, 3:] == -1).all() and (tv.numpy()[:, 3:] == np.float32(-3e38)).all()


def test_stream_dense_topk_casts_queries_to_a_bf16_store(rng):
    """A bf16 store scores bf16-rounded queries (the Pallas contract)."""
    q, x, _ = _data(rng, 2, 200, 32)
    xb = T(x).to(torch.bfloat16)
    tv, _ = stream_dense_topk(T(q), xb, 5)
    ref = (T(q).to(torch.bfloat16).float() @ xb.float().T).sort(1, descending=True)[0]
    np.testing.assert_allclose(tv.numpy(), ref[:, :5].numpy(), rtol=TOL, atol=TOL)


# ---- blocked_topk: every store form, both mask shapes ---------------------

FORMS = ["f32", "bf16", "int8", "int8_2pass", "resid", "resid_2pass"]


def _stores(form, x, cent):
    """The JAX and port stores of one form, built by each package."""
    if form in ("f32", "bf16"):
        jdt = jnp.float32 if form == "f32" else jnp.bfloat16
        tdt = torch.float32 if form == "f32" else torch.bfloat16
        return (jnp.asarray(x, jdt), {}), (T(x).to(tdt), {})
    if form.startswith("resid"):
        j8, js, ja = jq.quantize_rows_residual(jnp.asarray(x), jnp.asarray(cent))
        t8, ts, ta = tq.quantize_rows_residual(T(x), T(cent))
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        return ((j8, dict(row_scale=js, assign=ja, centroids=jnp.asarray(cent))),
                (t8, dict(row_scale=ts, assign=ta, centroids=T(cent))))
    j8, js = jq.quantize_rows(jnp.asarray(x))
    t8, ts = tq.quantize_rows(T(x))
    return (j8, dict(row_scale=js)), (t8, dict(row_scale=ts))


@pytest.mark.parametrize("mask_kind", ["none", "rows", "per_query"])
@pytest.mark.parametrize("form", FORMS)
def test_blocked_topk_matches_jax(rng, form, mask_kind):
    B, N, D, k = 5, 2500, 64, 12
    q, x, cent = _data(rng, B, N, D)
    (je, jkw), (te, tkw) = _stores(form, x, cent)
    two = form.endswith("2pass")
    mask = {"none": None, "rows": rng.random(N) > 0.4,
            "per_query": rng.random((B, N)) > 0.4}[mask_kind]
    jv, ji = jt.blocked_topk(jnp.asarray(q), je, k, block=1024, query_2pass=two,
                             mask=None if mask is None else jnp.asarray(mask), **jkw)
    tv, ti = tt.blocked_topk(T(q), te, k, block=1024, query_2pass=two,
                             mask=None if mask is None else T(mask), **tkw)
    assert_same_topk(tv, ti, jv, ji)


@pytest.mark.parametrize("form", ["f32", "int8", "resid_2pass"])
def test_blocked_topk_overflow_rows_are_minus_one(rng, form):
    q, x, cent = _data(rng, 3, 900, 32)
    (je, jkw), (te, tkw) = _stores(form, x, cent)
    mask = np.zeros(900, bool)
    mask[[0, 511, 512, 899]] = True
    two = form.endswith("2pass")
    jv, ji = jt.blocked_topk(jnp.asarray(q), je, 9, mask=jnp.asarray(mask),
                             block=256, query_2pass=two, **jkw)
    tv, ti = tt.blocked_topk(T(q), te, 9, mask=T(mask), block=256,
                             query_2pass=two, **tkw)
    assert_same_topk(tv, ti, jv, ji)
    assert (ti.numpy()[:, 4:] == -1).all()


@pytest.mark.parametrize("block", [64, 700, 1 << 20])
def test_blocked_topk_block_size_does_not_change_the_result(rng, block):
    q, x, _ = _data(rng, 4, 2000, 48)
    e8, sc = tq.quantize_rows(T(x))
    ref = tt.blocked_topk(T(q), e8, 20, row_scale=sc, query_2pass=True)
    got = tt.blocked_topk(T(q), e8, 20, row_scale=sc, query_2pass=True, block=block)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_blocked_topk_takes_more_queries_than_one_kernel_call(rng):
    """130 queries run as two K3 batches (128 + 2); the result is the
    whole batch's."""
    q, x, _ = _data(rng, 130, 600, 32)
    mask = rng.random((130, 600)) > 0.5
    tv, ti = tt.blocked_topk(T(q), T(x), 7, mask=T(mask))
    jv, ji = jt.blocked_topk(jnp.asarray(q), jnp.asarray(x), 7, mask=jnp.asarray(mask))
    assert tv.shape == (130, 7)
    assert_same_topk(tv, ti, jv, ji)


def test_blocked_topk_refuses_what_jax_refuses(rng):
    q, x, cent = _data(rng, 2, 50, 16)
    with pytest.raises(ValueError, match="query_2pass"):
        tt.blocked_topk(T(q), T(x), 3, query_2pass=True)
    with pytest.raises(ValueError, match="residual"):
        tt.blocked_topk(T(q), T(x), 3, assign=torch.zeros(50, dtype=torch.int32),
                        centroids=T(cent))
    with pytest.raises(ValueError, match="row_scale"):
        tt.blocked_topk(T(q), tq.quantize_rows(T(x))[0], 3)


def test_blocked_topk_approx_rt_is_exact(rng):
    q, x, _ = _data(rng, 3, 1200, 32)
    e8, sc = tq.quantize_rows(T(x))
    a = tt.blocked_topk(T(q), e8, 10, row_scale=sc, approx_rt=0.9)
    b = tt.blocked_topk(T(q), e8, 10, row_scale=sc)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    j8, js = jq.quantize_rows(jnp.asarray(x))
    jv, ji = jt.blocked_topk(jnp.asarray(q), j8, 10, row_scale=js, approx_rt=0.9)
    assert_same_topk(a[0], a[1], jv, ji)


# ---- the one-shot functions: large_topk_from_scores, approx_topk, dense_topk

@pytest.mark.parametrize("approx_rt", [None, 0.95])
def test_large_topk_from_scores_matches_jax(rng, approx_rt):
    s = rng.normal(size=(4, 3000)).astype(np.float32)
    s[:, 100:110] = s[:, 50:60]                              # exact ties
    jv, ji = jt.large_topk_from_scores(jnp.asarray(s), 25, approx_rt=approx_rt)
    tv, ti = tt.large_topk_from_scores(T(s), 25, approx_rt=approx_rt)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("masked", [False, True])
def test_approx_topk_matches_jax(rng, form, masked):
    q, x, cent = _data(rng, 4, 1800, 64)
    (je, jkw), (te, tkw) = _stores(form, x, cent)
    mask = rng.random(1800) > 0.5 if masked else None
    jv, ji = jt.approx_topk(jnp.asarray(q), je, 15, recall_target=0.95,
                            mask=None if mask is None else jnp.asarray(mask), **jkw)
    tv, ti = tt.approx_topk(T(q), te, 15, recall_target=0.95,
                            mask=None if mask is None else T(mask), **tkw)
    assert_same_topk(tv, ti, jv, ji)


@pytest.mark.parametrize("mask_kind", ["rows", "per_query"])
def test_dense_topk_overflow_follows_the_one_shot_top_k(rng, mask_kind):
    """k beyond the eligible rows: the one-shot top-k's overflow slots are
    masked rows at NEG_INF, lowest first; the int8 arm (a streaming scan)
    fills them in the same way."""
    q, x, _ = _data(rng, 3, 400, 32)
    mask = np.zeros((3, 400), bool) if mask_kind == "per_query" else np.zeros(400, bool)
    mask[..., [7, 200, 399]] = True
    if mask_kind == "per_query":
        mask[1, 0] = True
    (j8, jkw), (t8, tkw) = _stores("int8", x, None)
    for je, te, jk, tk in ((jnp.asarray(x), T(x), {}, {}), (j8, t8, jkw, tkw)):
        jv, ji = jt.dense_topk(jnp.asarray(q), je, 10, mask=jnp.asarray(mask), **jk)
        tv, ti = tt.dense_topk(T(q), te, 10, mask=T(mask), **tk)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


def test_fill_overflow_leaves_complete_rows_alone(rng):
    v = torch.tensor([[3.0, 2.0, -3e38], [1.0, -3e38, -3e38]])
    r = torch.tensor([[4, 9, -1], [2, -1, -1]], dtype=torch.int32)
    m = torch.ones(10, dtype=torch.bool)
    m[[0, 5, 6]] = False
    fv, fr = tt.fill_overflow(v, r, m)
    assert fr.tolist() == [[4, 9, 0], [2, 0, 5]] and torch.equal(fv, v)
    assert tt.fill_overflow(v, r, None)[1] is r


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas", "blocked"])
def test_dense_topk_impls_match_jax(rng, impl):
    q, x, _ = _data(rng, 70, 900, 32)                        # 70 > K1's 64
    mask = rng.random(900) > 0.3
    jv, ji = jt.dense_topk(jnp.asarray(q), jnp.asarray(x), 20, mask=jnp.asarray(mask),
                           impl=impl)
    tv, ti = tt.dense_topk(T(q), T(x), 20, mask=T(mask), impl=impl)
    assert_same_topk(tv, ti, jv, ji)


def test_dense_topk_refuses_bad_arguments(rng):
    q, x, _ = _data(rng, 2, 30, 16)
    with pytest.raises(ValueError, match="impl"):
        tt.dense_topk(T(q), T(x), 3, impl="fast")
    with pytest.raises(ValueError, match="row_scale"):
        tt.dense_topk(T(q), tq.quantize_rows(T(x))[0], 3)
    with pytest.raises(ValueError, match="row_scale"):
        tt.approx_topk(T(q), tq.quantize_rows(T(x))[0], 3)


# ---- the wrapper and its plain version --------------------------------------

def test_stream_topk_plain_takes_a_per_query_mask(rng):
    q, x, _ = _data(rng, 3, 500, 16)
    m = rng.random((3, 500)) > 0.5
    tv, ti = stream_topk_plain(T(q), T(x), 6, T(m), block=128)
    for b in range(3):
        rv, ri = stream_topk_plain(T(q[b:b + 1]), T(x), 6, T(m[b]))
        torch.testing.assert_close(tv[b], rv[0], rtol=TOL, atol=TOL)
        assert torch.equal(ti[b], ri[0])
        assert m[b][ti[b].numpy()].all()


def test_stream_topk_never_falls_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises."""
    q = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        stream_topk(q, torch.zeros((4, 8), device="meta"), 2)


# ---- the kernel's planner (pure Python: the grid each call launches) -------

from rag_challenge_2_tpu_torch.ops import stream_topk as sk  # noqa: E402


@pytest.mark.parametrize("B,two_pass,regime,tile", [
    (1, False, "int8_small", 16), (4, False, "int8_small", 16),
    (16, False, "int8_small", 16), (17, False, "int8_large", 64),
    (64, False, "int8_large", 64), (65, False, "int8_large", 128),
    (127, False, "int8_large", 128), (128, False, "int8_large", 128),
    (1, True, "int8_small", 16), (8, True, "int8_small", 16),
    (9, True, "int8_large", 64), (32, True, "int8_large", 64),
    (33, True, "int8_large", 128), (64, True, "int8_large", 128),
    (65, True, "int8_large", 256), (128, True, "int8_large", 256),
])
def test_plan_picks_the_int8_regime_from_the_batch(B, two_pass, regime, tile):
    """The small regime holds at most 16 code rows (2B in 2-pass); above
    it, the smallest large tile that holds them."""
    p = sk.plan(B, two_pass, True, 1_666_666, 132)
    assert (p.regime, p.query_tile) == (regime, tile)
    assert p.query_tile >= (2 * B if two_pass else B)


@pytest.mark.parametrize("N", [1, 127, 128, 129, 5000, 1_666_666, 10_000_000])
@pytest.mark.parametrize("B,two_pass", [(4, False), (8, True), (127, False), (127, True)])
def test_plan_reads_the_store_once_per_int8_call(N, B, two_pass):
    """A persistent grid of row chunks, each for all queries: the chunks
    tile N exactly once, in whole 128-row tiles, with at most one (large)
    or two (small) blocks per SM."""
    sms = 132
    p = sk.plan(B, two_pass, True, N, sms)
    assert p.store_passes == 1
    assert p.tile_rows == sk.INT8_TILE_ROWS and p.rows_per_chunk % p.tile_rows == 0
    assert (p.n_chunks - 1) * p.rows_per_chunk < N <= p.n_chunks * p.rows_per_chunk
    per_sm = sk.SMALL_BLOCKS_PER_SM if p.regime == "int8_small" else sk.LARGE_BLOCKS_PER_SM
    assert p.n_chunks <= per_sm * sms


@pytest.mark.parametrize("B,passes", [(1, 1), (64, 1), (65, 2), (128, 2)])
def test_plan_keeps_the_float_forms_first_design(B, passes):
    """f32 / bf16: the first design read the store ``passes`` times (once
    per 64 queries); the query tile now holds the whole batch, so every
    batch reads it once, on at most two blocks per SM."""
    p = sk.plan(B, False, False, 1_000_000, 132)
    assert p.regime == "float" and p.store_passes == 1 <= passes
    assert p.query_tile >= B and p.cut.query_tile == p.query_tile
    assert p.n_chunks <= 2 * 132


def test_planner_constants_are_the_ones_the_plan_uses():
    assert sk.CONSTANTS[:8] == (128, 16, 2, 1, 64, 128, 256, 16)
    assert sk.CONSTANTS[8:] == fs.FLOAT_CONSTANTS
    assert fs.FLOAT_CONSTANTS[-6:] == (512, 256, 256, 256, 128, 128)
    assert set(sk.stream_topk.regime_launches) == set(sk.REGIMES)


# ---- the f32 / bf16 arm of the planner (scan_float's grid) ------------------

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from rag_challenge_2_tpu_torch.ops import float_scan as fs  # noqa: E402
from tests.test_torch_topk import check_float_plan  # noqa: E402


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 128), N=st.one_of(st.integers(1, 5000), st.integers(1, 12_000_000)),
       k=st.integers(1, 64), elt=st.sampled_from([2, 4]),
       sms=st.sampled_from([108, 114, 132]))
def test_float_plan_sweep(B, N, k, elt, sms):
    # bf16 rows of D % 8 != 0 values: a store TMA cannot take, scan_float's
    # grid at every batch
    p = sk.plan(B, False, False, N, sms, k, elt, 1001, False)
    assert p.regime == "float"
    assert (p.query_tile, p.tile_rows, p.rows_per_chunk, p.n_chunks) == (
        p.cut.query_tile, p.cut.tile_rows, p.cut.rows_per_chunk, p.cut.n_chunks)
    check_float_plan(p.cut, B, N, k, elt, sms)


@pytest.mark.parametrize("B,tile,rows", [
    (8, 8, 512), (16, 16, 256), (17, 32, 256), (64, 64, 256), (65, 96, 128),
    (96, 96, 128), (97, 128, 128), (127, 128, 128), (128, 128, 128)])
def test_float_plan_query_tile_at_1m(B, tile, rows):
    """The query tile follows the batch (B = 65 pays for 96, once), and a
    1M-row store fills a persistent grid of whole tiles."""
    p = sk.plan(B, False, False, 1_000_000, 132, 30, 4).cut
    assert (p.query_tile, p.tile_rows) == (tile, rows)
    assert p.box_rows == p.tile_rows and p.rows_per_chunk % p.tile_rows == 0
    assert 0.9 * p.blocks_per_sm * 132 <= p.n_chunks <= p.blocks_per_sm * 132


def test_scratch_chunks_cover_the_merge_levels():
    for n in (1, 63, 64, 65, 132, 264):
        assert sk.scratch_chunks(n) == n + -(-n // 64)


# ---- the bf16_tc regime: where the planner picks it, and the exact split ---

@pytest.mark.parametrize("B,elt,D,aligned,regime", [
    (17, 2, 1024, True, "bf16_tc"), (127, 2, 1024, True, "bf16_tc"),
    (128, 2, 1024, True, "bf16_tc"), (64, 2, 1000, True, "bf16_tc"),
    (33, 2, 8, True, "bf16_tc"),
    (16, 2, 1024, True, "float"), (1, 2, 1024, True, "float"),      # B <= 16
    (127, 4, 1024, True, "float"), (17, 4, 1024, True, "float"),    # f32 rows
    (127, 2, 1001, True, "float"), (127, 2, 100, True, "float"),    # D % 8 != 0
    (127, 2, 1024, False, "float"),                                 # a misaligned view
])
def test_plan_picks_bf16_tc_only_where_tma_and_the_batch_allow(B, elt, D, aligned, regime):
    """bf16_tc: a bf16 store, more than 16 queries, rows of D % 8 == 0
    values and a base on 16 bytes; everything else stays on scan_float."""
    p = sk.plan(B, False, False, 1_500_000, 132, 30, elt, D, aligned)
    assert p.regime == regime
    assert (p.cut is None) == (regime == "bf16_tc")
    assert sk.tc_takes(B, elt, D, aligned) == (regime == "bf16_tc")


@pytest.mark.parametrize("B", [8, 127])
@pytest.mark.parametrize("D,aligned", [(None, True), (1024, None), (None, None)])
def test_plan_needs_a_bf16_stores_layout(B, D, aligned):
    """A bf16 plan without the store's width or alignment would describe a
    regime the wrapper may not run: it is refused.  int8 and f32 plans
    need neither."""
    with pytest.raises(ValueError, match="bf16"):
        sk.plan(B, False, False, 1_500_000, 132, 30, 2, D, aligned)
    assert sk.plan(B, False, False, 1_500_000, 132, 30, 4).regime == "float"
    assert sk.plan(B, False, True, 1_500_000, 132).regime.startswith("int8")


@pytest.mark.parametrize("B,tile", [(17, 32), (32, 32), (33, 64), (64, 64), (65, 96),
                                    (96, 96), (97, 128), (127, 128), (128, 128)])
@pytest.mark.parametrize("N", [1, 1_700, 250_000, 1_500_000])
def test_bf16_tc_plan_reads_the_store_once(B, tile, N):
    """The smallest query tile that holds the batch; a persistent grid of
    one block per SM, each owning whole 128-row tiles for all queries, so
    the chunks cover every row exactly once."""
    sms = 132
    p = sk.plan(B, False, False, N, sms, 30, 2, 1024, True)
    assert (p.regime, p.query_tile) == ("bf16_tc", tile)
    assert p.tile_rows == 2 * sk.TC_TILE_ROWS       # two tiles a stage at k = 30
    assert p.store_passes == 1 and p.rows_per_chunk % p.tile_rows == 0
    assert (p.n_chunks - 1) * p.rows_per_chunk < N <= p.n_chunks * p.rows_per_chunk
    assert p.n_chunks <= sms


@pytest.mark.parametrize("B", [1, 8, 16, 17, 33, 64])
@pytest.mark.parametrize("N", [10_240, 250_000, 1_500_000])
def test_k1_keeps_scan_float_for_bf16(B, N):
    """K1 (``dense_topk_fused``, up to 64 queries) is not rerouted: its
    planner still cuts scan_float's grid for a bf16 store."""
    from rag_challenge_2_tpu_torch.ops.dense_topk import plan as k1_plan

    p = k1_plan(B, N, 30, True, 132)
    assert isinstance(p, fs.FloatPlan) and p.query_tile == max(8, min(
        t for t in fs.TILES if t >= B))


def test_bf16_tc_constants_and_rings():
    """The regime's constants in the library's order, and a ring of at
    least two stages for every query tile at every k."""
    assert sk.TC_CONSTANTS == (128, 32, 64, 96, 128, 16, 17, 3)
    assert "bf16_tc" in sk.REGIMES and "bf16_tc" in sk.stream_topk.regime_launches
    for qt in sk.TC_QUERY_TILES:
        for k in range(1, sk.MAX_K + 1):
            for tiles in (1, 2):
                n = sk.tc_stages(qt, tiles, k)
                stage, total = sk.tc_smem_bytes(qt, tiles, k, n)
                assert stage % 1024 == 0 and n <= fs.MAX_STAGES
                assert n == fs.MAX_STAGES or total + stage > fs.SMEM_BLOCK_MAX
                assert tiles == 2 or (n >= 2 and total <= fs.SMEM_BLOCK_MAX)
            # two tiles a stage wherever their ring of two fits
            p = sk.plan(qt, False, False, 10**6, 132, k, 2, 1024, True)
            assert p.tile_rows == (2 if sk.tc_stages(qt, 2, k) >= 2 else 1) * sk.TC_TILE_ROWS
    assert sk.tc_stages(128, 2, 64) < 2 <= sk.tc_stages(128, 2, 30)


def _all_bits(rng, n):
    """f32 values whose 24 significant bits are all set, at exponents
    across [-100, 100], both signs."""
    e = rng.integers(-100, 101, n)
    m = np.float64(2 ** 24 - 1) / 2 ** 23
    return (np.where(rng.random(n) < 0.5, -1.0, 1.0) * m * np.exp2(e)).astype(np.float32)


def test_split_bf16x3_is_exact():
    """hi + mid + lo == q bitwise, over random f32 of magnitudes 1e-30 to
    1e30, both signs, and values with all 24 significant bits set; each
    plane is a bf16 value and the planes fall by at least 2^8 each."""
    rng = np.random.default_rng(0)
    mags = np.exp(rng.uniform(np.log(1e-30), np.log(1e30), 200_000))
    q = (np.where(rng.random(mags.size) < 0.5, -1.0, 1.0) * mags).astype(np.float32)
    q = np.concatenate([q, _all_bits(rng, 20_000), np.float32([0.0, -0.0, 1.0, -1.0])])
    qt = torch.from_numpy(q)
    hi, mid, lo = sk.split_bf16x3(qt)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.float() + mid.float() + lo.float(), qt)
    assert torch.equal((hi.float() + mid.float()) + lo.float(), hi.float() + (mid.float() + lo.float()))
    nz = mid.float() != 0
    assert bool((mid.float()[nz].abs() <= hi.float()[nz].abs() * 2.0 ** -8).all())
    # a value already in bf16 has empty lower planes
    b = qt.to(torch.bfloat16).float()
    h, m, l = sk.split_bf16x3(b)
    assert torch.equal(h.float(), b) and not m.float().any() and not l.float().any()


def test_split_bf16x3_below_2_to_the_minus_110():
    """Below 2^-110 (and for f32 subnormals) the split may miss q, by at
    most 2^-134: lo's last bits fall under bf16's least subnormal."""
    rng = np.random.default_rng(1)
    e = rng.uniform(-149, -110, 50_000)
    q = (np.where(rng.random(e.size) < 0.5, -1.0, 1.0) * np.exp2(e)).astype(np.float32)
    qt = torch.from_numpy(q)
    hi, mid, lo = sk.split_bf16x3(qt)
    miss = (hi.double() + mid.double() + lo.double() - qt.double()).abs()
    assert float(miss.max()) <= 2.0 ** -134
    assert bool((qt.abs() < 2.0 ** -126).any())                     # subnormals met
