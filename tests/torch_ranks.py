"""Rank programs of the port's multi-process tests.

Each function runs on every rank of a gloo world on the CPU that a test
starts with ``rag_challenge_2_tpu_torch.parallel.launch.run_ranks``; rank
0's return value comes back to the test.  A rank is a fresh interpreter
that imports this module, so it imports torch and the port only, never
JAX (the tests compare what comes back with the JAX package in the parent).
Inputs arrive as numpy arrays and results leave as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

BLOCKED = ("jax", "jaxlib", "flax", "rag_challenge_2_tpu")


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _np(xs):
    return tuple(x.numpy() for x in xs)


def jax_modules():
    """Modules of JAX or the JAX package this process has imported."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)


def _mesh(axes):
    from rag_challenge_2_tpu_torch.parallel import make_mesh

    return make_mesh(dict(axes), "gloo", "cpu")


def mesh_layout(dev, axes_list):
    """Per mesh: every rank's (rank, axis names, local rank per axis,
    flattened shard index), in rank order."""
    from rag_challenge_2_tpu_torch.parallel.mesh import axis_index

    out = []
    for axes in axes_list:
        m = _mesh(axes)
        mine = (dist.get_rank(), tuple(m.mesh_dim_names),
                tuple(m.get_local_rank(a) for a in axes), axis_index(m, tuple(axes)))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        out.append(every)
    return out


def mesh_errors(dev):
    """What ``make_mesh`` raises for a mesh that does not fit this world."""
    from rag_challenge_2_tpu_torch.parallel import make_mesh

    out = {}
    for name, call in (
            ("size", lambda: make_mesh({"data": 2 * dist.get_world_size()})),
            ("backend", lambda: make_mesh({"data": dist.get_world_size()}, "nccl")),
            ("device", lambda: make_mesh({"data": dist.get_world_size()}, "gloo", "cuda"))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def no_jax(dev):
    """Import the whole port, run a sharded search, and list what of JAX
    this rank imported (and which of those names are blocked here)."""
    import importlib
    import pkgutil

    import rag_challenge_2_tpu_torch as pkg
    from rag_challenge_2_tpu_torch.parallel import sharded_dense_topk

    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if not m.name.endswith("__main__"):
            importlib.import_module(m.name)
    g = torch.Generator().manual_seed(0)
    v, r = sharded_dense_topk(torch.randn(2, 8, generator=g),
                              torch.randn(64, 8, generator=g), 4,
                              _mesh({"data": dist.get_world_size()}))
    blocked = sorted(n for n in BLOCKED if n in sys.modules and sys.modules[n] is None)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (jax_modules(), r.tolist(), blocked))
    return every


def fail_on_rank(dev, rank):
    """Raise on ``rank``; the others wait in a collective that never
    completes, until the launcher ends the world."""
    if dist.get_rank() == rank:
        raise ValueError(f"planted failure on rank {rank}")
    dist.barrier()
    return "unreachable"


def dense_cases(dev, cases):
    """``sharded_dense_topk`` / ``hierarchical_dense_topk`` for each case:
    dict(axes, q, emb, k, mask=None, row_scale=None); two-axis meshes run
    the two-level merge."""
    from rag_challenge_2_tpu_torch.parallel import (
        hierarchical_dense_topk, sharded_dense_topk)

    out = []
    for c in cases:
        m = _mesh(c["axes"])
        args = (_t(c["q"]), _t(c["emb"]), c["k"], m)
        kw = dict(mask=_t(c.get("mask")), row_scale=_t(c.get("row_scale")))
        if len(c["axes"]) == 2:
            s_ax, d_ax = tuple(c["axes"])
            out.append(_np(hierarchical_dense_topk(*args, slice_axis=s_ax,
                                                   dev_axis=d_ax, **kw)))
        else:
            out.append(_np(sharded_dense_topk(*args, axis=tuple(c["axes"])[0], **kw)))
    return out


def _sharded_engine(index_path, axes, sparse, ivf_arrays, window0):
    """This rank's engine over a row-sharded copy of the saved index:
    ``emb`` / ``emb_scale`` keep the rank's rows, BM25 is a
    ``ShardedSparseIndex`` when ``sparse``, and ``ivf_arrays`` (a JAX
    ShardedIVF as numpy) gives the rank its ``ShardedIVF``."""
    from rag_challenge_2_tpu_torch.index import load_index
    from rag_challenge_2_tpu_torch.parallel.mesh import axis_index
    from rag_challenge_2_tpu_torch.parallel.sharded_ivf import from_jax_sharded_ivf
    from rag_challenge_2_tpu_torch.parallel.sharded_search import shard_rows, shard_vec
    from rag_challenge_2_tpu_torch.parallel.sharded_sparse import shard_sparse_index
    from rag_challenge_2_tpu_torch.retrieval import QueryEngine

    idx, meta = load_index(index_path, device="cpu")
    mesh = _mesh(axes)
    grid = tuple(axes)
    S = dist.get_world_size()
    idx = dataclasses.replace(
        idx, emb=shard_rows(idx.emb, mesh, grid),
        emb_scale=None if idx.emb_scale is None else shard_vec(idx.emb_scale, mesh, grid),
        sparse=shard_sparse_index(idx.sparse, S, mesh, grid) if sparse else idx.sparse)
    ivf = (None if ivf_arrays is None else
           from_jax_sharded_ivf(ivf_arrays, axis_index(mesh, grid), mesh, grid,
                                device="cpu"))
    eng = QueryEngine(idx, meta, ivf=ivf, hier=(mesh, grid[0], grid[1]))
    if window0:
        eng.window = 0
    return eng


def engine_cases(dev, index_path, axes, sparse, ivf_arrays, calls, window0=False):
    """``QueryEngine(hier=...)`` over the row-sharded index: for each call
    (query embeddings, years, SearchConfig kwargs, BM25 texts) the
    materialized results, or the error it raised as ``(type, message)``.
    Every rank must return the same results; rank 0 checks."""
    from rag_challenge_2_tpu_torch.retrieval import SearchConfig

    eng = _sharded_engine(index_path, axes, sparse, ivf_arrays, window0)
    out = []
    for q, years, kw, texts in calls:
        cfg = SearchConfig(**kw)
        try:
            res = eng.materialize(eng.search(q, "金盘科技", "营业收入", years, cfg,
                                             query_texts=texts), cfg)
        except (NotImplementedError, ValueError) as e:
            res = (type(e).__name__, str(e))
        out.append(res)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    if any(o != out for o in every):
        raise AssertionError("the ranks of a sharded engine disagree")
    return out


def engine_search_many(dev, index_path, axes, qs, years, kw, texts):
    """``search_many`` of the sharded engine: one ``FusedCandidates`` per
    request, as numpy ``(key, score)``."""
    from rag_challenge_2_tpu_torch.retrieval import SearchConfig

    eng = _sharded_engine(index_path, axes, True, None, False)
    out = eng.search_many(qs, "金盘科技", "营业收入", years, SearchConfig(**kw),
                          query_texts_list=texts)
    return [(c.key.numpy(), c.score.numpy()) for c in out]


def bm25_cases(dev, index_path, calls):
    """``sharded_bm25_topk`` over a ``ShardedSparseIndex`` with one shard
    a rank, for each call (query term ids, doc masks, k, row_slot)."""
    from rag_challenge_2_tpu_torch.index import load_index
    from rag_challenge_2_tpu_torch.parallel.sharded_sparse import (
        shard_sparse_index, sharded_bm25_topk)

    idx, _ = load_index(index_path, device="cpu")
    S = dist.get_world_size()
    ss = shard_sparse_index(idx.sparse, S, _mesh({"data": S}))
    return [_np(sharded_bm25_topk(ss, _t(qt), _t(dm), k, row_slot=_t(slot)))
            for qt, dm, k, slot in calls]


def ivf_cases(dev, groups):
    """``sharded_ivf_search`` on JAX ShardedIVFs carried across (one shard
    a rank): for each (arrays, calls) group, each call dict(q, k, nprobe,
    win_start=None, win_len=None)."""
    from rag_challenge_2_tpu_torch.parallel.sharded_ivf import (
        from_jax_sharded_ivf, sharded_ivf_search)

    mesh = _mesh({"data": dist.get_world_size()})
    out = []
    for arrays, calls in groups:
        sivf = from_jax_sharded_ivf(arrays, dist.get_rank(), mesh, device="cpu")
        out.append([_np(sharded_ivf_search(
            sivf, _t(c["q"]), c["k"], nprobe=c["nprobe"],
            win_start=_t(c.get("win_start")), win_len=_t(c.get("win_len"))))
            for c in calls])
    return out


def ivf_build(dev, emb, n_clusters, q, k, nprobes):
    """The port's own ``build_sharded_ivf`` (k-means on this rank's rows):
    every rank's (k_clusters, n_pad, max_list, rows_per_shard), the search
    at each ``nprobe``, and the error of a corpus too small to shard."""
    from rag_challenge_2_tpu_torch.parallel.sharded_ivf import (
        build_sharded_ivf, sharded_ivf_search)

    mesh = _mesh({"data": dist.get_world_size()})
    sivf = build_sharded_ivf(_t(emb), mesh, n_clusters=n_clusters, seed=0)
    shape = (sivf.k_clusters, sivf.local.emb_perm.shape[0], sivf.max_list,
             sivf.rows_per_shard, sivf.local.max_list)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, shape)
    found = [_np(sharded_ivf_search(sivf, _t(q), k, nprobe=p)) for p in nprobes]
    try:
        build_sharded_ivf(torch.zeros(dist.get_world_size() - 1, 8), mesh, n_clusters=1)
        err = None
    except ValueError as e:
        err = str(e)
    return every, found, err


def hier_ivf_cases(dev, jobs):
    """``QueryEngine(hier=...)`` serving ``use_ivf`` from one IVF over the
    whole store, for each job dict(index_path, axes, calls, build=kwargs
    of ``build_ivf`` or None, ivf_path=a whole-store IVF sidecar to
    ``shard_ivf`` or None): this rank's view of the IVF (the shared
    centroids, its rows' global ids and clusters, the global list bounds,
    k_clusters, max_list) and the materialized results of each call.  The
    results must be equal on every rank, bit for bit; rank 0 checks."""
    from rag_challenge_2_tpu_torch.index import load_ivf
    from rag_challenge_2_tpu_torch.parallel.mesh import axis_index
    from rag_challenge_2_tpu_torch.parallel.sharded_ivf import shard_ivf
    from rag_challenge_2_tpu_torch.retrieval import SearchConfig

    out = []
    for job in jobs:
        eng = _sharded_engine(job["index_path"], job["axes"], True, None, False)
        mesh, grid = eng.hier[0], eng.hier[1:]
        rps = eng.index.emb.shape[0]
        if job.get("build") is not None:
            sivf = eng.build_ivf(**job["build"])
        else:
            sivf = eng.ivf = shard_ivf(load_ivf(job["ivf_path"], device="cpu"), mesh,
                                       grid, rows_per_shard=rps)
        local = sivf.local
        live = local.row_ids >= 0
        base = axis_index(mesh, grid) * rps
        mine = dict(centroids=local.centroids.numpy(),
                    rows=(local.row_ids[live].long() + base).numpy(),
                    clusters=local.pos_cluster[live].numpy(),
                    list_row_min=sivf.list_row_min.numpy(),
                    list_row_max=sivf.list_row_max.numpy(),
                    k_clusters=sivf.k_clusters, max_list=sivf.max_list,
                    dtype=str(local.emb_perm.dtype))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        res = []
        for q, years, kw, texts in job["calls"]:
            cfg = SearchConfig(**kw)
            res.append(eng.materialize(eng.search(q, "金盘科技", "营业收入", years, cfg,
                                                  query_texts=texts), cfg))
        same = [None] * dist.get_world_size()
        dist.all_gather_object(same, repr(res))
        if any(x != repr(res) for x in same):
            raise AssertionError("the ranks of a sharded engine disagree")
        out.append((every, res))
    return out


def _details_np(details):
    """A search's details as numpy: TraversalResults as tuples of arrays."""
    return {k: tuple(x.numpy() for x in v) if isinstance(v, tuple) else v.numpy()
            for k, v in details.items()}


def traversal_cases(dev, jobs):
    """The traversal methods of ``QueryEngine(hier=...)`` over row-sharded
    stores, each job on a mesh of its own ``axes`` over the world.  A job
    is dict(index_path, axes, calls,
    sparse=True, ivf_arrays=None, window0=False, many=None): for each call
    (query embeddings, years, SearchConfig kwargs, BM25 texts) the
    materialized results, the details (numpy) and ``materialize_details``;
    ``many`` (list of query embeddings, years, kwargs, list of texts) runs
    ``search_many`` and materializes each request.  Every rank must return
    the same, bit for bit; rank 0 checks."""
    from rag_challenge_2_tpu_torch.retrieval import SearchConfig

    out = []
    for job in jobs:
        eng = _sharded_engine(job["index_path"], job["axes"], job.get("sparse", True),
                              job.get("ivf_arrays"), job.get("window0", False))
        got = []
        for q, years, kw, texts in job["calls"]:
            cfg = SearchConfig(**kw)
            cands, details = eng.search(q, "金盘科技", "营业收入", years, cfg,
                                        query_texts=texts, with_details=True)
            got.append((eng.materialize(cands, cfg), _details_np(details),
                        eng.materialize_details(details, cfg)))
        many = None
        if job.get("many") is not None:
            qs, years, kw, texts = job["many"]
            cfg = SearchConfig(**kw)
            many = [eng.materialize(c, cfg) for c in eng.search_many(
                qs, "金盘科技", "营业收入", years, cfg, query_texts_list=texts)]
        out.append((got, many))
    mine = repr([(r, m, [sorted((k, v.tobytes() if hasattr(v, "tobytes") else
                                 tuple(x.tobytes() for x in v)) for k, v in d.items())])
                 for got, many in out for r, d, m in got] + [o[1] for o in out])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if any(e != mine for e in every):
        raise AssertionError("the ranks of a sharded engine disagree")
    return out
