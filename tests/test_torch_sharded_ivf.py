"""The port's distributed IVF (``parallel/sharded_ivf.py``) against the JAX
package (``tests/test_sharded_ivf.py``'s twins), on the JAX build carried
across: k-means differs between the packages (and on the card is not
bit-reproducible), so the search is held on one shared build.

The JAX side runs on its 4-device CPU mesh in this process; the port's in
a gloo world of 4 ranks, one shard a rank (``run_ranks``, rank programs
in ``tests/torch_ranks.py``).  Rows are equal and f32 values within 1e-5
(int8: 1e-4, the twin's tolerance); at ``nprobe = K`` every list is probed
and the rows are the exact top-k."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rag_challenge_2_tpu.index import build_corpus_index as jax_build
from rag_challenge_2_tpu.index.ivf import build_ivf as jax_build_ivf
from rag_challenge_2_tpu.index.ivf import ivf_search as jax_ivf_search
from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu.parallel.mesh import make_mesh as jax_mesh
from rag_challenge_2_tpu.parallel.sharded_ivf import build_sharded_ivf as jax_build_sharded
from rag_challenge_2_tpu.parallel.sharded_ivf import sharded_ivf_search as jax_sharded_search
from rag_challenge_2_tpu.parallel.sharded_sparse import shard_sparse_index as jax_shard_sparse
from rag_challenge_2_tpu.retrieval.engine import QueryEngine as JaxEngine
from rag_challenge_2_tpu.retrieval.engine import SearchConfig as JaxCfg
from rag_challenge_2_tpu_torch.index import load_index
from rag_challenge_2_tpu_torch.index.ivf import ivf_search
from rag_challenge_2_tpu_torch.ops.topk import NEG_INF, dense_topk
from rag_challenge_2_tpu_torch.parallel import launch
from rag_challenge_2_tpu_torch.parallel.sharded_ivf import from_jax_sharded_ivf
from rag_challenge_2_tpu_torch.retrieval import QueryEngine
from rag_challenge_2_tpu_torch.retrieval import SearchConfig as TorchCfg
from tests import torch_ranks
from tests.conftest import make_reports
from tests.test_torch_engine import assert_same_results

S = 4
N, D, K_CLUSTERS = 2048, 32, 8
_FIELDS = ("centroids", "emb_perm", "row_ids", "pos_cluster", "list_offsets",
           "row_scale", "list_row_min", "list_row_max")
_STATICS = ("k_clusters", "max_list", "dim", "n_shards", "rows_per_shard")


def carry(sivf):
    """A JAX ShardedIVF as numpy arrays (its stacked fields and statics)."""
    out = {f: None if getattr(sivf, f) is None else np.array(getattr(sivf, f))
           for f in _FIELDS}
    out.update({f: getattr(sivf, f) for f in _STATICS})
    return out


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return _unit(rng, N, D), _unit(rng, 5, D)


@pytest.fixture(scope="module")
def builds(corpus):
    """The JAX builds: f32 and int8 over the corpus (the twin's), and the
    narrow one (256 x 16, 32 lists: one probe holds fewer rows than k)."""
    emb, _ = corpus
    mesh = jax_mesh({"data": S})
    f32 = jax_build_sharded(jnp.asarray(emb), mesh, n_clusters=K_CLUSTERS, seed=0)
    i8 = jax_build_sharded(jnp.asarray(emb), mesh, n_clusters=K_CLUSTERS, seed=0,
                           quantize=True)
    narrow_emb = _unit(np.random.default_rng(3), 256, 16)
    narrow = jax_build_sharded(jnp.asarray(narrow_emb), mesh, n_clusters=32, seed=0)
    return dict(f32=f32, i8=i8, narrow=narrow, narrow_emb=narrow_emb, mesh=mesh)


CALLS = {   # name -> (build, call)
    "np2": ("f32", dict(k=10, nprobe=2)),
    "npK": ("f32", dict(k=10, nprobe=K_CLUSTERS)),
    "window": ("f32", dict(k=10, nprobe=K_CLUSTERS, win_start=512, win_len=1024)),
    "int8": ("i8", dict(k=10, nprobe=2)),
    "narrow": ("narrow", dict(k=10, nprobe=1)),
}


def _call(name, corpus, builds):
    build, c = CALLS[name]
    q = builds["narrow_emb"][:3] + 0.01 if build == "narrow" else corpus[1]
    c = dict(c, q=q.astype(np.float32))
    if "win_start" in c:
        c["win_start"] = np.full(len(q), c["win_start"], np.int32)
        c["win_len"] = np.full(len(q), c["win_len"], np.int32)
    return build, c


@pytest.fixture(scope="module")
def port(corpus, builds):
    """Every call of this file's carried searches in one 4-rank world."""
    groups = {b: [] for b in ("f32", "i8", "narrow")}
    for name in CALLS:
        build, c = _call(name, corpus, builds)
        groups[build].append((name, c))
    got = launch.run_ranks(torch_ranks.ivf_cases, S, "gloo", "cpu", (
        [(carry(builds[b]), [c for _, c in calls]) for b, calls in groups.items()],))
    return {name: res for (b, calls), out in zip(groups.items(), got)
            for (name, _), res in zip(calls, out)}


def _jax(name, corpus, builds):
    build, c = _call(name, corpus, builds)
    kw = {}
    if "win_start" in c:
        kw = dict(win_start=jnp.asarray(c["win_start"]), win_len=jnp.asarray(c["win_len"]))
    v, r = jax_sharded_search(builds[build], jnp.asarray(c["q"]), c["k"], builds["mesh"],
                              nprobe=c["nprobe"], **kw)
    return np.asarray(v), np.asarray(r)


def _replay(builds, build, q, k, nprobe):
    """The port's host-sequential reference: each carried shard searched
    alone, merged by (-value, lower global row)."""
    arrays = carry(builds[build])
    rps = arrays["rows_per_shard"]
    vs, rs = [], []
    for s in range(S):
        sh = from_jax_sharded_ivf(arrays, s, None, device="cpu")
        v, r = ivf_search(sh.local, torch.from_numpy(q),
                          min(k, rps, nprobe * sh.max_list), nprobe=nprobe,
                          window=sh.max_list)
        vs.append(v.numpy())
        rs.append(np.where(r.numpy() >= 0, r.numpy() + s * rps, -1))
    av, ai = np.concatenate(vs, 1), np.concatenate(rs, 1)
    order = [np.lexsort((np.where(ai[b] >= 0, ai[b], 2 ** 30), -av[b]))[:k]
             for b in range(len(q))]
    return (np.stack([av[b][o] for b, o in enumerate(order)]),
            np.stack([ai[b][o] for b, o in enumerate(order)]))


def test_sharded_matches_sequential_replay(corpus, builds, port):
    v, r = port["np2"]
    jv, jr = _jax("np2", corpus, builds)
    assert r.tolist() == jr.tolist()
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    rv, rr = _replay(builds, "f32", corpus[1], 10, 2)
    assert r.tolist() == rr.tolist()
    np.testing.assert_allclose(v, rv, rtol=1e-6, atol=1e-6)


def test_sharded_recall_beats_matched_single(corpus, builds, port):
    emb, q = corpus
    oracle = dense_topk(torch.from_numpy(q), torch.from_numpy(emb), 10)[1].numpy()
    single = jax_build_ivf(jnp.asarray(emb), n_clusters=K_CLUSTERS, iters=10, seed=0)
    rows_1 = np.asarray(jax_ivf_search(single, jnp.asarray(q), 10, nprobe=2)[1])

    def recall(rows):
        return np.mean([len(set(rows[b].tolist()) & set(oracle[b].tolist())) / 10
                        for b in range(len(q))])

    r_sh = recall(port["np2"][1])
    assert r_sh >= recall(rows_1) - 1e-9 and r_sh > 0.5


def test_nprobe_k_is_the_exact_top_k(corpus, port):
    emb, q = corpus
    v, r = port["npK"]
    ov, orow = dense_topk(torch.from_numpy(q), torch.from_numpy(emb), 10)
    assert r.tolist() == orow.numpy().tolist()
    np.testing.assert_allclose(v, ov.numpy(), rtol=1e-6, atol=1e-6)


def test_sharded_int8_store(corpus, builds, port):
    assert builds["i8"].emb_perm.dtype == jnp.int8
    v, r = port["int8"]
    jv, jr = _jax("int8", corpus, builds)
    assert r.tolist() == jr.tolist()
    np.testing.assert_allclose(v, jv, rtol=1e-4, atol=1e-4)
    rv, rr = _replay(builds, "i8", corpus[1], 10, 2)
    assert r.tolist() == rr.tolist()
    np.testing.assert_array_equal(v, rv)      # a shard's scores do not depend on S


def test_sharded_window_routing(corpus, builds, port):
    """A global row range spanning shards 1 and 2: rows stay inside it and,
    every list probed, equal the masked exact top-k and the JAX search."""
    emb, q = corpus
    v, rows = port["window"]
    live = rows >= 0
    assert live.any() and ((rows[live] >= 512) & (rows[live] < 1536)).all()
    mask = np.zeros(N, bool)
    mask[512:1536] = True
    want = dense_topk(torch.from_numpy(q), torch.from_numpy(emb), 10,
                      mask=torch.from_numpy(mask))[1].numpy()
    assert rows.tolist() == want.tolist()
    assert rows.tolist() == _jax("window", corpus, builds)[1].tolist()


def test_narrow_probe_window(corpus, builds, port):
    """k above nprobe x max_list: each shard returns min(k, P x W) columns,
    the merge pads to k with (NEG_INF, -1)."""
    assert builds["narrow"].max_list < 10
    v, rows = port["narrow"]
    assert v.shape == (3, 10) and rows.shape == (3, 10)
    for b in range(3):
        real = rows[b] >= 0
        assert real.sum() >= 4 and b in rows[b][real]
        assert np.all(np.diff(v[b][real]) <= 1e-6)
        assert (rows[b][~real] == -1).all() and (v[b][~real] <= NEG_INF / 2).all()
    jv, jr = _jax("narrow", corpus, builds)
    assert rows.tolist() == jr.tolist()
    np.testing.assert_allclose(v[rows >= 0], jv[jr >= 0], rtol=1e-5, atol=1e-5)


def test_port_build_sharded_ivf(corpus):
    """The port's own build, k-means on each rank's rows: common shapes on
    every rank, the exact top-k at nprobe = K, the twin's recall bar, and
    too few rows raises."""
    emb, q = corpus
    shapes, found, err = launch.run_ranks(torch_ranks.ivf_build, S, "gloo", "cpu",
                                          (emb, K_CLUSTERS, q, 10, [2, K_CLUSTERS]))
    assert len(set(shapes)) == 1
    k, n_pad, max_list, rps, local_max = shapes[0]
    assert (k, rps, local_max) == (K_CLUSTERS, N // S, max_list)
    oracle = dense_topk(torch.from_numpy(q), torch.from_numpy(emb), 10)[1].numpy()
    assert found[1][1].tolist() == oracle.tolist()
    recall = np.mean([len(set(found[0][1][b]) & set(oracle[b])) / 10 for b in range(5)])
    assert recall > 0.5
    assert "cannot shard" in err


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """The twin's engine test: a ShardedIVF (window layout) + ShardedSparseIndex
    + row-sharded store over a (2 x 2) world; the JAX build carried across."""
    rng = np.random.default_rng(0)
    reports, embs = make_reports(rng)
    idx, meta = jax_build(reports, embs, vocab_bits=12)
    path = tmp_path_factory.mktemp("ivf") / "idx.npz"
    jax_save(path, idx, meta)
    mesh = jax_mesh({"data": S})
    sivf = jax_build_sharded(idx.emb, mesh, n_clusters=2, iters=5, valid=idx.valid)
    all_q = np.concatenate(embs)
    qs = [all_q[7][None, :], all_q[[7, 20]]]
    calls = [(q.astype(np.float32), years, dict(CFG, **kw), ["营业收入"])
             for kw in (dict(use_ivf=True, ivf_nprobe=2), dict(use_ivf=True, ivf_nprobe=1))
             for years in (None, [2024]) for q in qs]
    got = launch.run_ranks(torch_ranks.engine_cases, S, "gloo", "cpu",
                           (str(path), {"slice": 2, "device": 2}, True, carry(sivf), calls))
    flat = launch.run_ranks(torch_ranks.engine_cases, S, "gloo", "cpu",
                            (str(path), {"slice": 2, "device": 2}, True, carry(sivf),
                             calls[:1], True))
    return idx, meta, path, mesh, sivf, calls, got, flat


CFG = dict(method="basic", top_k=5, top_n=40, use_bm25=True)


def test_engine_hybrid_on_fully_sharded_index(engine):
    """At nprobe = K the probes are exact: the sharded engine equals the
    single-device port engine's exact path and the JAX engine over its
    sharded index; at nprobe 1 it equals the JAX engine."""
    idx, meta, path, mesh, sivf, calls, got, _ = engine
    tidx, tmeta = load_index(path, device="cpu")
    single = QueryEngine(tidx, tmeta)
    jidx = dataclasses.replace(
        idx, emb=jax.device_put(idx.emb, NamedSharding(mesh, P("data", None))),
        valid=jax.device_put(idx.valid, NamedSharding(mesh, P("data"))),
        sparse=jax_shard_sparse(idx.sparse, S, mesh=mesh))
    jeng = JaxEngine(jidx, meta, ivf=sivf)
    exact = TorchCfg(**CFG)
    for (q, years, kw, texts), res in zip(calls, got):
        assert res and any(r["method_count"] == 2 for r in res)
        if kw["ivf_nprobe"] == 2:
            want = single.materialize(single.search(q, "金盘科技", "营业收入", years, exact,
                                                    query_texts=texts), exact)
            assert_same_results(res, want)
        jc = JaxCfg(**kw)
        jres = jeng.materialize(jeng.search(q, "金盘科技", "营业收入", years, jc,
                                            query_texts=texts), jc)
        assert_same_results(res, jres)


def test_engine_sharded_ivf_needs_the_window_layout(engine):
    (kind, msg), = engine[-1]
    assert kind == "ValueError" and "contiguous doc-window layout" in msg
