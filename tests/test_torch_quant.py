"""The int8 stores of ``ops/quant.py`` and ``index/store.quantize_index``
against the JAX package on the CPU.

The eager functions agree bitwise: quantization (codes and scales), the
2-pass query, the residual codes, and ``int8_scores``.  The top-k
functions are jitted in the JAX package, where XLA computes the query
scale as ``amax * (1 / 127)`` and contracts the 2-pass residual into an
FMA, so their scores agree within 1e-5 (as do scores with the f32
centroid bias, an f32 matmul summed in another order); rows are compared
with ``assert_same_topk``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.index.store import quantize_index as jax_quantize_index
from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu.ops import quant as jq
from rag_challenge_2_tpu_torch.index import load_index, quantize_index, save_index
from rag_challenge_2_tpu_torch.ops import quant as tq
from tests.test_torch_stream_topk import _data, _unit
from tests.test_torch_topk import assert_same_topk

TOL = 1e-5
T = torch.from_numpy


def _residual_stores(x, cent):
    j = jq.quantize_rows_residual(jnp.asarray(x), jnp.asarray(cent))
    t = tq.quantize_rows_residual(T(x), T(cent))
    return j, t


# ---- the eager functions: bitwise ------------------------------------------

def test_quantize_query_2pass_matches_jax_bitwise(rng):
    q, _, _ = _data(rng, 40, 10, 96)
    q[3] = 0.0                                         # a padded query
    j8, jh, jl = jq.quantize_query_2pass(jnp.asarray(q))
    t8, th, tl = tq.quantize_query_2pass(T(q))
    assert t8.dtype == torch.int8 and t8.shape == (80, 96)
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert th[3] == 0 and tl[3] == 0 and (t8[[3, 43]] == 0).all()


def test_two_pass_query_is_closer_than_one_pass(rng):
    q, _, _ = _data(rng, 30, 10, 128)
    q8, s = tq.quantize_rows(T(q))
    err1 = (q8.float() * s[:, None] - T(q)).abs().max()
    q2, sh, sl = tq.quantize_query_2pass(T(q))
    back = q2[:30].float() * sh[:, None] + q2[30:].float() * sl[:, None]
    err2 = (back - T(q)).abs().max()
    assert err2 < err1 / 50


def test_int8_scores_match_jax_bitwise(rng):
    q, x, _ = _data(rng, 6, 700, 64)
    j8, js = jq.quantize_rows(jnp.asarray(x))
    t8, ts = tq.quantize_rows(T(x))
    jsc = np.asarray(jq.int8_scores(jnp.asarray(q), j8, js))
    tsc = tq.int8_scores(T(q), t8, ts).numpy()
    np.testing.assert_array_equal(tsc, jsc)
    assert np.abs(tsc - q @ x.T).max() < 0.02          # close to the f32 scores


@pytest.mark.parametrize("D", [64, 1040, 1100])
@pytest.mark.parametrize("batched", [False, True])
def test_i8_dot_is_exact(rng, D, batched):
    """f32 products up to D = 1040, f64 above: equal to int64 sums."""
    shape_a, shape_b = ((3, 5, D), (3, 7, D)) if batched else ((5, D), (7, D))
    a = rng.integers(-127, 128, size=shape_a).astype(np.int8)
    b = rng.integers(-127, 128, size=shape_b).astype(np.int8)
    a[..., 0, :] = 127                                  # the largest sums
    b[..., 0, :] = 127
    got = tq.i8_dot(T(a), T(b))
    want = np.einsum("...md,...nd->...mn", a.astype(np.int64), b.astype(np.int64))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_wide_int8_rows_match_jax(rng):
    """int8 rows wider than 1040 (the f64 branch of ``i8_dot``) through
    ``int8_scores``, the plain scan and the rescoring stage."""
    B, N, D = 3, 400, 1100
    q, x, cent = _data(rng, B, N, D)
    j8, js = jq.quantize_rows(jnp.asarray(x))
    t8, ts = tq.quantize_rows(T(x))
    jsc = np.asarray(jq.int8_scores(jnp.asarray(q), j8, js))
    np.testing.assert_array_equal(tq.int8_scores(T(q), t8, ts).numpy(), jsc)
    tv, ti = tq.int8_topk(T(q), t8, ts, 9)
    jv, ji = jq.int8_topk(jnp.asarray(q), j8, js, 9)
    assert_same_topk(tv, ti, jv, ji)
    (r8, rs, ra), (u8, us, ua) = _residual_stores(x, cent)
    jv, ji = jq.int8_residual_topk_rescored(jnp.asarray(q), r8, rs, ra, jnp.asarray(cent),
                                            5, k_cand=20)
    tv, ti = tq.int8_residual_topk_rescored(T(q), u8, us, ua, T(cent), 5, k_cand=20)
    assert_same_topk(tv, ti, jv, ji)


@pytest.mark.parametrize("given_assign", [False, True])
def test_quantize_rows_residual_matches_jax(rng, given_assign):
    _, x, cent = _data(rng, 1, 900, 48)
    assign = None
    if given_assign:
        assign = rng.integers(0, cent.shape[0], 900).astype(np.int32)
    (j8, js, ja), (t8, ts, ta) = (
        jq.quantize_rows_residual(jnp.asarray(x), jnp.asarray(cent),
                                  None if assign is None else jnp.asarray(assign)),
        tq.quantize_rows_residual(T(x), T(cent), None if assign is None else T(assign)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_residual_scores_match_jax(rng):
    q, x, cent = _data(rng, 5, 600, 64)
    (j8, js, ja), (t8, ts, ta) = _residual_stores(x, cent)
    jsc = np.asarray(jq.int8_residual_scores(jnp.asarray(q), j8, js, ja, jnp.asarray(cent)))
    tsc = tq.int8_residual_scores(T(q), t8, ts, ta, T(cent)).numpy()
    np.testing.assert_allclose(tsc, jsc, rtol=TOL, atol=TOL)


# ---- the scans ---------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", ["none", "rows", "per_query", "few"])
def test_int8_topk_matches_jax(rng, mask_kind):
    B, N = 4, 1500
    q, x, _ = _data(rng, B, N, 64)
    j8, js = jq.quantize_rows(jnp.asarray(x))
    t8, ts = tq.quantize_rows(T(x))
    mask = {"none": None, "rows": rng.random(N) > 0.5,
            "per_query": rng.random((B, N)) > 0.5,
            "few": np.isin(np.arange(N), [9, 800, 1499])}[mask_kind]
    k = 12
    jv, ji = jq.int8_topk(jnp.asarray(q), j8, js, k,
                          None if mask is None else jnp.asarray(mask))
    tv, ti = tq.int8_topk(T(q), t8, ts, k, None if mask is None else T(mask))
    assert_same_topk(tv, ti, jv, ji)
    if mask_kind == "few":                 # one-shot overflow: masked rows, lowest first
        np.testing.assert_array_equal(ti.numpy()[:, 3:], np.asarray(ji)[:, 3:])
        assert ti.numpy()[0, 3:].tolist() == list(range(9))


@pytest.mark.parametrize("query_2pass", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_int8_residual_topk_matches_jax(rng, query_2pass, masked):
    B, N = 5, 2000
    q, x, cent = _data(rng, B, N, 64)
    (j8, js, ja), (t8, ts, ta) = _residual_stores(x, cent)
    mask = rng.random(N) > 0.3 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else T(mask)
    jv, ji = jq.int8_residual_topk(jnp.asarray(q), j8, js, ja, jnp.asarray(cent), 15,
                                   jm, query_2pass=query_2pass)
    tv, ti = tq.int8_residual_topk(T(q), t8, ts, ta, T(cent), 15, tm,
                                   query_2pass=query_2pass)
    assert_same_topk(tv, ti, jv, ji)
    jv, ji = jq.int8_residual_approx_topk(jnp.asarray(q), j8, js, ja, jnp.asarray(cent),
                                          15, recall_target=0.95, mask=jm,
                                          query_2pass=query_2pass)
    av, ai = tq.int8_residual_approx_topk(T(q), t8, ts, ta, T(cent), 15,
                                          recall_target=0.95, mask=tm,
                                          query_2pass=query_2pass)
    assert_same_topk(av, ai, jv, ji)
    assert torch.equal(av, tv) and torch.equal(ai, ti)   # approx is exact here


@pytest.mark.parametrize("k,k_cand,n_ok", [(10, 48, None), (5, 20, None),
                                           (10, 48, 30), (8, 48, 4)])
def test_int8_residual_topk_rescored_matches_jax(rng, k, k_cand, n_ok):
    """Including fewer eligible rows than k_cand (the -1 candidates stay
    out) and than k."""
    B, N = 6, 2500
    q, x, cent = _data(rng, B, N, 64)
    (j8, js, ja), (t8, ts, ta) = _residual_stores(x, cent)
    mask = None
    if n_ok is not None:
        mask = np.zeros(N, bool)
        mask[rng.choice(N, n_ok, replace=False)] = True
    jv, ji = jq.int8_residual_topk_rescored(
        jnp.asarray(q), j8, js, ja, jnp.asarray(cent), k, k_cand=k_cand,
        mask=None if mask is None else jnp.asarray(mask))
    tv, ti = tq.int8_residual_topk_rescored(
        T(q), t8, ts, ta, T(cent), k, k_cand=k_cand,
        mask=None if mask is None else T(mask))
    assert_same_topk(tv, ti, jv, ji)
    if n_ok is not None and n_ok < k:
        assert (ti.numpy()[:, n_ok:] == -1).all()


def test_rescored_recall_beats_plain_int8(rng):
    """The recall lever at small scale, on the 10M bench's recipe (unit
    centres + (0.35/sqrt D) noise, queries = rows + (0.25/sqrt D) noise):
    the residual code reconstructs rows closer than plain int8, and the
    rescored residual scan finds more of the exact top-10."""
    N, D, nc, B = 6000, 128, 64, 60
    cent = _unit(rng.normal(size=(nc, D)))
    x = _unit(cent[rng.integers(0, nc, N)] + 0.35 / np.sqrt(D) * rng.normal(size=(N, D)))
    q = _unit(x[rng.integers(0, N, B)] + 0.25 / np.sqrt(D) * rng.normal(size=(B, D)))
    exact = np.argsort(-(q @ x.T), axis=1, kind="stable")[:, :10]
    t8, ts = tq.quantize_rows(T(x))
    _, plain = tq.int8_topk(T(q), t8, ts, 10)
    r8, rs, ra = tq.quantize_rows_residual(T(x), T(cent))
    _, resc = tq.int8_residual_topk_rescored(T(q), r8, rs, ra, T(cent), 10)
    back = T(cent)[ra.long()] + r8.float() * rs[:, None]
    assert (back - T(x)).abs().mean() < (t8.float() * ts[:, None] - T(x)).abs().mean() / 2

    def recall(got):
        return np.mean([len(set(got[i]) & set(exact[i])) / 10 for i in range(B)])

    assert recall(resc.numpy()) > recall(plain.numpy()) and recall(resc.numpy()) >= 0.95


# ---- quantize_index ----------------------------------------------------------

def test_quantize_index_matches_jax_and_is_idempotent(tiny_corpus, tmp_path):
    idx, meta, _, _ = tiny_corpus
    jax_save(tmp_path / "f32.npz", idx, meta)
    jax_save(tmp_path / "i8.npz", jax_quantize_index(idx), meta)
    tidx, tmeta = load_index(tmp_path / "f32.npz", device="cpu")
    q8 = quantize_index(tidx)
    ref, _ = load_index(tmp_path / "i8.npz", device="cpu")
    assert q8.emb.dtype == torch.int8 and tidx.emb.dtype == torch.float32
    assert torch.equal(q8.emb, ref.emb) and torch.equal(q8.emb_scale, ref.emb_scale)
    assert quantize_index(q8) is q8                      # codes are not re-quantized
    save_index(tmp_path / "again.npz", q8, tmeta)        # and loads in JAX's layout
    back, _ = load_index(tmp_path / "again.npz", device="cpu")
    assert torch.equal(back.emb, q8.emb) and torch.equal(back.emb_scale, q8.emb_scale)
