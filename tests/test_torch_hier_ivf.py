"""One IVF over the whole store on a row-sharded engine:
``QueryEngine(hier=...).build_ivf()`` of the port against the JAX
package's, which clusters the whole store and serves ``use_ivf`` from it.

The port's side runs once, in one gloo world of 4 ranks on the CPU
(``run_ranks``, rank program ``tests/torch_ranks.hier_ivf_cases``), over
an index the JAX package built and saved; the JAX side runs its
``hier=`` engine on a 2 x 2 mesh of its virtual CPU devices.  The
corpus's rows are drawn around 8 unit centres, most of a document's rows
around two of them, so k-means has one answer and a document's window
makes some lists ineligible.  Tolerances: centroids within 1e-5 (f32
sums taken in another order), assignments and list bounds equal, the
materialized results as ``tests/test_torch_engine.assert_same_results``
holds them (scores within 1e-5, rows equal, ties grouped)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rag_challenge_2_tpu.index import build_corpus_index as jax_build
from rag_challenge_2_tpu.index.store import quantize_index as jax_quantize_index
from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu.index.store import save_ivf as jax_save_ivf
from rag_challenge_2_tpu.parallel.mesh import make_mesh as jax_mesh
from rag_challenge_2_tpu.retrieval.engine import QueryEngine as JaxEngine
from rag_challenge_2_tpu.retrieval.engine import SearchConfig as JaxCfg
from rag_challenge_2_tpu_torch.index import build_ivf, load_index
from rag_challenge_2_tpu_torch.parallel import launch
from rag_challenge_2_tpu_torch.retrieval import QueryEngine
from tests import torch_ranks
from tests.conftest import make_reports
from tests.test_torch_engine import _q_for, assert_same_results

AXES = {"slice": 2, "device": 2}
K, ITERS = 8, 6
CALLS = {
    "ivf_np2": dict(top_k=5, top_n=40, use_ivf=True, ivf_nprobe=2),
    "ivf_np2_bm25": dict(top_k=5, top_n=100, use_ivf=True, ivf_nprobe=2,
                         use_bm25=True, bm25_top_k=12),
    "ivf_all_lists": dict(top_k=8, top_n=40, use_ivf=True, ivf_nprobe=64),
}
YEARS = [None, [2023]]
# (name, JAX index variant, build_ivf kwargs)
JOBS = [
    ("f32", "f32", dict(n_clusters=K, iters=ITERS)),
    ("f32_capped", "f32", dict(n_clusters=K, iters=ITERS, max_list_size=24)),
    ("f32_default_k", "f32", dict(iters=ITERS)),
    ("int8_quantize", "int8", dict(n_clusters=K, iters=ITERS, quantize=True)),
]


def _clustered_reports(rng, dim=32, spread=0.04):
    """3 reports of 100 chunks; most of report d's rows sit around
    centres 2d and 2d + 1, the rest around any of the 8."""
    reports, _ = make_reports(rng, pages_per_doc=10, chunks_per_page=10, dim=dim)
    for r in reports:                  # a BM25 length of its own per chunk: no ties
        for c in r["content"]["chunks"]:
            c["text"] += " " + "填" * (c["id"] + 1)
    centres = rng.normal(size=(8, dim)).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    embs = []
    for d in range(3):
        own = rng.integers(2 * d, 2 * d + 2, size=100)
        c = np.where(rng.random(100) < 0.8, own, rng.integers(0, 8, size=100))
        e = centres[c] + spread * rng.normal(size=(100, dim)).astype(np.float32)
        embs.append((e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32))
    return reports, embs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(16)
    reports, embs = _clustered_reports(rng)
    idx, meta = jax_build(reports, embs, vocab_bits=16)
    assert int(np.asarray(idx.valid).sum()) < idx.emb.shape[0]   # padding rows
    tmp = tmp_path_factory.mktemp("hier_ivf")
    variants = {"f32": idx, "int8": jax_quantize_index(idx)}
    paths = {}
    for name, ix in variants.items():
        paths[name] = str(tmp / f"{name}.npz")
        jax_save(paths[name], ix, meta)
    qs = [_q_for(embs, 0, 17, rng),
          np.concatenate([_q_for(embs, 0, 3, rng), _q_for(embs, 1, 40, rng)])]
    texts = ["营业收入 chunk17", "页面3 chunk40 金盘科技"]
    calls = [(q, years, kw, texts) for kw in CALLS.values() for years in YEARS for q in qs]
    mesh = jax_mesh(AXES)
    grid = NamedSharding(mesh, P(tuple(AXES), None))
    jax_engines, jobs = {}, []
    for name, variant, build in JOBS:
        ix = variants[variant]
        je = JaxEngine(dataclasses.replace(ix, emb=jax.device_put(ix.emb, grid)), meta,
                       hier=(mesh, *AXES))
        je.build_ivf(**build)
        jax_engines[name] = je
        jobs.append(dict(index_path=paths[variant], axes=AXES, calls=calls, build=build))
    # the JAX whole-store IVF itself, sharded over the ranks by shard_ivf
    ivf_path = str(tmp / "f32.ivf.npz")
    jax_save_ivf(ivf_path, jax_engines["f32"].ivf)
    jobs.append(dict(index_path=paths["f32"], axes=AXES, calls=calls, ivf_path=ivf_path))
    jax_engines["shard_ivf"] = jax_engines["f32"]
    got = launch.run_ranks(torch_ranks.hier_ivf_cases, 4, "gloo", "cpu", (jobs,))
    names = [n for n, _, _ in JOBS] + ["shard_ivf"]
    return dict(zip(names, got)), jax_engines, calls


def _rows_to_clusters(rows, clusters, n):
    out = np.full(n, -1, np.int64)
    out[rows] = clusters
    return out


@pytest.mark.parametrize("name", [n for n, _, _ in JOBS] + ["shard_ivf"])
def test_hier_build_ivf_is_the_whole_store_ivf(world, name):
    """Every rank holds the JAX whole-store IVF's centroids (within 1e-5,
    bitwise the same on every rank), each row sits in the JAX list of
    that row, and the shared list bounds are the JAX IVF's."""
    got, jax_engines, _ = world
    every, _ = got[name]
    jivf = jax_engines[name].ivf
    n = int(np.asarray(jivf.row_ids).max()) + 1
    jrow = np.asarray(jivf.row_ids)
    live = jrow >= 0
    want = _rows_to_clusters(jrow[live], np.asarray(jivf.pos_cluster)[live], n)
    rows = np.concatenate([e["rows"] for e in every])
    assert sorted(rows.tolist()) == sorted(jrow[live].tolist())
    have = _rows_to_clusters(rows, np.concatenate([e["clusters"] for e in every]), n)
    np.testing.assert_array_equal(have, want)
    for e in every:
        assert e["k_clusters"] == jivf.k_clusters
        np.testing.assert_array_equal(e["centroids"], every[0]["centroids"])
        np.testing.assert_allclose(e["centroids"], np.asarray(jivf.centroids),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(e["list_row_min"], np.asarray(jivf.list_row_min))
        np.testing.assert_array_equal(e["list_row_max"], np.asarray(jivf.list_row_max))
        # the common probe window: the longest of any rank's own lists
        assert e["max_list"] == max(np.bincount(x["clusters"], minlength=1).max()
                                    for x in every)
    if name == "f32_capped":
        assert jivf.k_clusters > K
    if name == "f32_default_k":
        assert jivf.k_clusters == int(np.sqrt(len(rows)) * 4)
    dtypes = {e["dtype"] for e in every}
    assert dtypes == {"torch.int8" if name == "int8_quantize" else "torch.float32"}


@pytest.mark.parametrize("call", list(CALLS))
@pytest.mark.parametrize("name", [n for n, _, _ in JOBS] + ["shard_ivf"])
def test_hier_use_ivf_matches_the_jax_whole_store_engine(world, name, call):
    """``use_ivf`` on every rank (equal on all four, checked in the world)
    returns the JAX ``hier=`` engine's results over its whole-store IVF."""
    got, jax_engines, calls = world
    _, results = got[name]
    je = jax_engines[name]
    n = 0
    for (q, years, kw, texts), res in zip(calls, results):
        if kw != CALLS[call]:
            continue
        jc = JaxCfg(**kw)
        jres = je.materialize(je.search(q, "金盘科技", "营业收入", years, jc,
                                        query_texts=texts), jc)
        assert res
        assert_same_results(res, jres)
        n += 1
    assert n == len(YEARS) * 2


def test_hier_engine_refuses_a_whole_store_ivf(tmp_path):
    """A plain IVFIndex on a row-sharded engine, passed or set, and
    cluster_order() there, raise and point to build_ivf()."""
    rng = np.random.default_rng(3)
    reports, embs = _clustered_reports(rng)
    idx, meta = jax_build(reports, embs, vocab_bits=16)
    jax_save(tmp_path / "i.npz", idx, meta)
    tidx, tmeta = load_index(tmp_path / "i.npz", device="cpu")
    ivf = build_ivf(tidx.emb, n_clusters=4, iters=2, valid=tidx.valid)
    with pytest.raises(ValueError, match=r"build_ivf\(\)"):
        QueryEngine(tidx, tmeta, ivf=ivf, hier=object())
    eng = QueryEngine(tidx, tmeta, hier=object())
    with pytest.raises(ValueError, match=r"build_ivf\(\)"):
        eng.ivf = ivf
    assert eng.ivf is None
    with pytest.raises(ValueError, match=r"build_ivf\(\)"):
        eng.cluster_order()
    assert QueryEngine(tidx, tmeta, ivf=ivf).ivf is ivf
    assert torch.equal(QueryEngine(tidx, tmeta, ivf=ivf).cluster_order().index.emb,
                       ivf.emb_perm)
