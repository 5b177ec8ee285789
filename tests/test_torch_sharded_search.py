"""The port's distributed top-k (``parallel/sharded_search.py``) and the
engine's ``hier=`` branch against the single-device port and the JAX
package (``tests/test_sharded_search.py``'s twins).

The JAX side runs on its 8-device virtual CPU mesh in this process; the
port's side in a gloo world on the CPU (``run_ranks``, rank programs in
``tests/torch_ranks.py``), one world per test function for all of its
cases.  f32 values agree within 1e-5 (the port's plain version and XLA's
HIGHEST product sum in other orders), rows are equal, ties included; int8
values are bitwise equal to the single-device scan."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rag_challenge_2_tpu.index import build_corpus_index as jax_build
from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu.ops.quant import quantize_rows as jax_quantize_rows
from rag_challenge_2_tpu.parallel.mesh import make_mesh as jax_mesh
from rag_challenge_2_tpu.parallel.sharded_search import (
    hierarchical_dense_topk as jax_hier, sharded_dense_topk as jax_sharded)
from rag_challenge_2_tpu.retrieval.engine import QueryEngine as JaxEngine
from rag_challenge_2_tpu.retrieval.engine import SearchConfig as JaxCfg
from rag_challenge_2_tpu_torch.index import load_index
from rag_challenge_2_tpu_torch.ops.topk import NEG_INF, dense_topk
from rag_challenge_2_tpu_torch.parallel import launch
from rag_challenge_2_tpu_torch.retrieval import QueryEngine
from rag_challenge_2_tpu_torch.retrieval import SearchConfig as TorchCfg
from tests import torch_ranks
from tests.conftest import make_reports
from tests.test_torch_engine import _q_for, assert_same_results

TOL = 1e-5


def _world(cases, n):
    return launch.run_ranks(torch_ranks.dense_cases, n, "gloo", "cpu", (cases,))


def _single(c):
    """The single-device port on the same inputs."""
    v, r = dense_topk(torch.from_numpy(c["q"]), torch.from_numpy(c["emb"]), c["k"],
                      mask=None if c.get("mask") is None else torch.from_numpy(c["mask"]),
                      row_scale=None if c.get("row_scale") is None
                      else torch.from_numpy(c["row_scale"]))
    return v.numpy(), r.numpy()


def _assert_equal(got, want, exact=False):
    (gv, gr), (wv, wr) = got, want
    ok = wv > NEG_INF / 2
    assert gv.shape == wv.shape
    if exact:
        np.testing.assert_array_equal(gv[ok], wv[ok])
    else:
        np.testing.assert_allclose(gv[ok], wv[ok], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(gr[ok], wr[ok])
    assert (gr[~ok] == -1).all() and (gv[~ok] <= NEG_INF / 2).all()


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# (N, D, B, k): the twin's two shapes, and k above rows_per_shard (40 / 4)
SHAPES = [(4096, 64, 4, 10), (1000, 32, 2, 7), (40, 16, 3, 12)]


@pytest.fixture(scope="module")
def flat_shapes():
    rng = np.random.default_rng(0)
    cases = [dict(axes={"data": 4}, q=_rand(rng, B, D), emb=_rand(rng, N, D), k=k)
             for N, D, B, k in SHAPES]
    return cases, _world(cases, 4)


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_sharded_matches_single_device(flat_shapes, case):
    cases, got = flat_shapes
    c = cases[case]
    _assert_equal(got[case], _single(c))
    jv, ji = jax_sharded(jnp.asarray(c["q"]), jnp.asarray(c["emb"]), c["k"],
                         jax_mesh({"data": 8}))
    _assert_equal(got[case], (np.asarray(jv), np.asarray(ji)))


def test_sharded_with_mask():
    rng = np.random.default_rng(1)
    N, D, B, k = 2048, 32, 3, 8
    c = dict(axes={"data": 4}, q=_rand(rng, B, D), emb=_rand(rng, N, D), k=k,
             mask=rng.random(N) > 0.5)
    (got,) = _world([c], 4)
    assert c["mask"][got[1]].all()
    _assert_equal(got, _single(c))
    jv, ji = jax_sharded(jnp.asarray(c["q"]), jnp.asarray(c["emb"]), k,
                         jax_mesh({"data": 8}), mask=jnp.asarray(c["mask"]))
    _assert_equal(got, (np.asarray(jv), np.asarray(ji)))


def test_sharded_uneven_rows():
    """N not divisible by the shard count: the pad rows never win."""
    rng = np.random.default_rng(2)
    N, D, B, k = 1001, 16, 2, 5
    c = dict(axes={"data": 4}, q=_rand(rng, B, D), emb=_rand(rng, N, D), k=k)
    sparse = dict(c, q=np.abs(c["q"]), emb=-np.abs(c["emb"]))   # pad rows (0) would win
    got, neg = _world([c, sparse], 4)
    assert ((got[1] >= 0) & (got[1] < N)).all() and ((neg[1] >= 0) & (neg[1] < N)).all()
    _assert_equal(got, _single(c))
    _assert_equal(neg, _single(sparse))
    jv, ji = jax_sharded(jnp.asarray(c["q"]), jnp.asarray(c["emb"]), k, jax_mesh({"data": 8}))
    _assert_equal(got, (np.asarray(jv), np.asarray(ji)))


def test_sharded_int8_matches_single_device():
    """int8 shards: every rank's K3 scores its rows as the single-device
    scan does, so values are bitwise equal; the JAX jitted scan within 1e-5."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1000, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(4, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e8, sc = (np.array(a) for a in jax_quantize_rows(jnp.asarray(x)))
    few = np.zeros(1000, bool)
    few[[3, 501, 998]] = True          # fewer eligible rows than k on every shard
    cases = [dict(axes={"data": 4}, q=q, emb=e8, k=10, row_scale=sc),
             dict(axes={"data": 4}, q=q, emb=e8, k=10, row_scale=sc, mask=few)]
    got = _world(cases, 4)
    for g, c in zip(got, cases):
        _assert_equal(g, _single(c), exact=True)
    for rows in got[1][1]:              # the 3 eligible rows, then none
        assert set(rows[:3]) == {3, 501, 998} and (rows[3:] == -1).all()
    jv, ji = jax_sharded(jnp.asarray(q), jnp.asarray(e8), 10, jax_mesh({"data": 8}),
                         row_scale=jnp.asarray(sc))
    np.testing.assert_allclose(got[0][0], np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[0][1], np.asarray(ji))


@pytest.fixture(scope="module")
def hier_cases():
    """One 8-rank world: the 2 x 4 and 4 x 2 two-level merges and the flat
    8-way merge over a store with a planted exact tie, then int8 + mask
    with uneven rows."""
    rng = np.random.default_rng(0)
    N, D, B, k = 4096, 64, 4, 10
    q = _rand(rng, B, D)
    emb = _rand(rng, N, D)
    emb[100] = emb[200]                 # planted exact tie: row 100 must win
    x = _rand(rng, 1001, 32)
    q8 = _rand(rng, 3, 32)
    e8, sc = (np.array(a) for a in jax_quantize_rows(jnp.asarray(x)))
    mask = rng.random(1001) > 0.5
    cases = [dict(axes={"slice": 2, "device": 4}, q=q, emb=emb, k=k),
             dict(axes={"slice": 4, "device": 2}, q=q, emb=emb, k=k),
             dict(axes={"data": 8}, q=q, emb=emb, k=k)]
    int8 = [dict(axes=a, q=q8, emb=e8, k=8, row_scale=sc, mask=mask)
            for a in ({"slice": 2, "device": 4}, {"data": 8})]
    return cases, int8, _world(cases + int8, 8)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_hierarchical_matches_flat_and_oracle(hier_cases, shape):
    cases, _, got = hier_cases
    i = 0 if shape == (2, 4) else 1
    c = cases[i]
    hv, hi = got[i]
    fv, fi = got[2]
    np.testing.assert_array_equal(hi, fi)                 # hier == flat, ties too
    np.testing.assert_array_equal(hv, fv)
    _assert_equal(got[i], _single(c))
    mesh = jax_mesh({"slice": shape[0], "device": shape[1]})
    jv, ji = jax_hier(jnp.asarray(c["q"]), jnp.asarray(c["emb"]), c["k"], mesh)
    _assert_equal(got[i], (np.asarray(jv), np.asarray(ji)))
    for rows in hi.tolist():           # the tie goes to the lower row
        assert 200 not in rows or rows.index(100) == rows.index(200) - 1


def test_hierarchical_int8_and_mask(hier_cases):
    _, int8, got = hier_cases
    (hv, hi), (fv, fi) = got[3], got[4]
    c = int8[0]
    assert c["mask"][hi].all()
    np.testing.assert_array_equal(hi, fi)
    np.testing.assert_array_equal(hv, fv)
    _assert_equal(got[3], _single(c), exact=True)
    jv, ji = jax_hier(jnp.asarray(c["q"]), jnp.asarray(c["emb"]), 8,
                      jax_mesh({"slice": 2, "device": 4}), mask=jnp.asarray(c["mask"]),
                      row_scale=jnp.asarray(c["row_scale"]))
    np.testing.assert_array_equal(hi, np.asarray(ji))
    np.testing.assert_allclose(hv, np.asarray(jv), rtol=1e-5, atol=1e-6)


# the engine's hier= branch: the twin's product-graph corpus (3 docs x 16
# chunks, n_pad divisible by the 2 x 4 grid), the row store sharded.  The
# JAX engine orders tied fused scores by an unstable sort and keeps other
# BM25 rows at a tied cut-off (ROADMAP C), so the configurations held
# against it keep every BM25 candidate (bm25_top_k >= 16 rows a document,
# top_n 40);
# the twin's own (top_n 10 cuts a group of tied BM25 scores) and parent
# pages (a page's representative row among rows of tied scores) are held
# against the single-device port engine, whose tie rule is the same.
PORT_ONLY = ("twin", "parent_pages")
ENGINE_CFGS = {
    "twin": dict(method="basic", top_k=5, top_n=10, use_bm25=True),
    "basic_bm25": dict(method="basic", top_k=5, top_n=40, use_bm25=True),
    "dense": dict(method="basic", top_k=5, top_n=10),
    "parent_pages": dict(method="basic", top_k=5, top_n=40, use_bm25=True,
                         bm25_top_k=16, return_parent_pages=True),
    "sum_weighted": dict(method="basic", top_k=8, top_n=40, use_bm25=True,
                         bm25_top_k=16, fuse_mode="sum", dense_weight=0.5),
    "k_over_rows": dict(method="basic", top_k=40, top_n=40, use_bm25=True),
}
YEARS = [None, [2023]]


@pytest.fixture(scope="module")
def hier_engine(tmp_path_factory):
    rng = np.random.default_rng(0)
    reports, embs = make_reports(rng, chunks_per_page=4)
    idx, meta = jax_build(reports, embs, vocab_bits=16)
    path = tmp_path_factory.mktemp("hier") / "idx.npz"
    jax_save(path, idx, meta)
    twin_q = embs[0][5][None, :].astype(np.float32)       # the twin's request
    qs = (_q_for(embs, 0, 5, rng),
          np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng)]))
    texts = ["营业收入 chunk5", "页面3 chunk7 金盘科技"]
    calls = [(twin_q, years, ENGINE_CFGS["twin"], ["营业收入"]) for years in YEARS]
    calls += [(q, years, kw, texts) for name, kw in ENGINE_CFGS.items()
              if name != "twin" for years in YEARS for q in qs]
    got = launch.run_ranks(torch_ranks.engine_cases, 8, "gloo", "cpu",
                           (str(path), {"slice": 2, "device": 4}, False, None, calls))
    return idx, meta, path, calls, got


@pytest.mark.parametrize("name", list(ENGINE_CFGS))
def test_engine_hier_merge_through_product_graph(hier_engine, name):
    """QueryEngine(hier=...) on a row-sharded store: materialized results
    equal the single-device port engine's and the JAX engine's with hier."""
    idx, meta, path, calls, got = hier_engine
    tidx, tmeta = load_index(path, device="cpu")
    single = QueryEngine(tidx, tmeta)
    mesh = jax_mesh({"slice": 2, "device": 4})
    grid = NamedSharding(mesh, P(("slice", "device"), None))
    jeng = JaxEngine(dataclasses.replace(idx, emb=jax.device_put(idx.emb, grid)), meta,
                     hier=(mesh, "slice", "device"))
    pages = ENGINE_CFGS[name].get("return_parent_pages", False)
    for (q, years, kw, texts), res in zip(calls, got):
        if kw != ENGINE_CFGS[name]:
            continue
        tc, jc = TorchCfg(**kw), JaxCfg(**kw)
        want = single.materialize(single.search(q, "金盘科技", "营业收入", years, tc,
                                                query_texts=texts), tc)
        assert res
        assert_same_results(res, want, parent_pages=pages)
        if name in PORT_ONLY:
            continue
        jres = jeng.materialize(jeng.search(q, "金盘科技", "营业收入", years, jc,
                                            query_texts=texts), jc)
        assert_same_results(res, jres, parent_pages=pages)


def test_engine_hier_search_many_equals_single_device(hier_engine, tmp_path):
    idx, meta, path, calls, _ = hier_engine
    rng = np.random.default_rng(3)
    qs = [rng.normal(size=(n, idx.emb.shape[1])).astype(np.float32) for n in (1, 3, 2)]
    texts = [["营业收入"], ["chunk5", "页面2"], None]
    kw = ENGINE_CFGS["basic_bm25"]
    got = launch.run_ranks(torch_ranks.engine_search_many, 4, "gloo", "cpu",
                           (str(path), {"slice": 2, "device": 2}, qs, None, kw, texts))
    tidx, tmeta = load_index(path, device="cpu")
    single = QueryEngine(tidx, tmeta)
    want = single.search_many(qs, "金盘科技", "营业收入", None, TorchCfg(**kw),
                              query_texts_list=texts)
    for (key, score), w in zip(got, want):
        np.testing.assert_array_equal(key, w.key.numpy())
        np.testing.assert_allclose(score, w.score.numpy(), rtol=TOL, atol=TOL)


def test_select_lowest_rows_carries_payload_columns():
    """Payload columns follow their candidates through the selection, ties
    included: equal values go to the lower row with that row's payload,
    and row-less candidates come last with theirs."""
    from rag_challenge_2_tpu_torch.parallel.sharded_search import select_lowest_rows

    vals = torch.tensor([[0.5, 0.9, 0.5, NEG_INF, 0.9, 0.7],
                         [NEG_INF, 0.2, NEG_INF, 0.2, 0.3, 0.2]])
    rows = torch.tensor([[40, 7, 3, -1, 2, 11], [-1, 9, 5, 1, 30, 4]], dtype=torch.int32)
    pay_a = rows.float() * 10 + 1
    pay_b = -rows.float()
    v, r, a, b = select_lowest_rows(vals, rows, 5, (pay_a, pay_b))
    assert r.tolist() == [[2, 7, 11, 3, 40], [30, 1, 4, 9, 5]]
    np.testing.assert_array_equal(v.numpy(), np.float32([[0.9, 0.9, 0.7, 0.5, 0.5],
                                                         [0.3, 0.2, 0.2, 0.2, NEG_INF]]))
    np.testing.assert_array_equal(a.numpy(), r.float().numpy() * 10 + 1)
    np.testing.assert_array_equal(b.numpy(), -r.float().numpy())
    # without payload: the same selection, two values back
    assert [x.tolist() for x in select_lowest_rows(vals, rows, 5)] == [v.tolist(), r.tolist()]
    # a row-less candidate keeps its payload and comes after every row
    v2, r2, a2 = select_lowest_rows(vals[:1], rows[:1], 6, (pay_a[:1],))
    assert r2[0, -1] == -1 and a2[0, -1] == -9.0
