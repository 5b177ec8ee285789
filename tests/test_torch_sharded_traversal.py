"""Traversal (``ssg``, ``triangulation``, ``hybrid_expansion``) through
``QueryEngine(hier=...)`` on a row-sharded store, the port's twin of
``tests/test_sharded_search.py::test_engine_traversal_on_row_sharded_index``.

Each rank of a gloo world on the CPU holds only its rows of the store
(``parallel.shard_rows`` over the flattened ``slice`` x ``device`` grid),
hops over them with the single-device hop's kernels' plain versions and
merges over the mesh (``parallel/sharded_traversal.py``); rank programs
are in ``tests/torch_ranks.py``: one world of 2, 3 and 4 ranks each, a
module fixture for all of its cases (the 4-rank world runs both the flat
``device`` 4 and the 2 x 2 mesh).  Every rank must return the same results and details, bit for bit.
They are held against the single-device port engine and the JAX engine
(with ``hier=`` on its 8-device virtual mesh) by
``tests/torch_engine_traversal_common.py``'s rules: fused scores within
1e-5 (1e-4 on an int8 store), keys, counts and rep rows equal; details
record for record, rows equal for the walkers clear of ties (at most 1%
left out); ``materialize_details`` equal with scores rounded to 4 places.

The corpus has three routed documents of 370 chunks (1,110 rows, 2,048
padded), so a document spans two ranks in every world, the 4-rank worlds
have a rank that holds none of the routed rows, and the 3-rank world's
rows do not divide (``shard_rows`` pads).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rag_challenge_2_tpu.index import build_corpus_index as jax_build
from rag_challenge_2_tpu.index.store import quantize_index as jax_quantize_index
from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu.parallel.mesh import make_mesh as jax_mesh
from rag_challenge_2_tpu.parallel.sharded_ivf import build_sharded_ivf as jax_build_sharded
from rag_challenge_2_tpu.parallel.sharded_sparse import shard_sparse_index as jax_shard_sparse
from rag_challenge_2_tpu.retrieval.engine import QueryEngine as JaxEngine
from rag_challenge_2_tpu.retrieval.engine import SearchConfig as JaxCfg
from rag_challenge_2_tpu_torch.index import load_index
from rag_challenge_2_tpu_torch.parallel import launch
from rag_challenge_2_tpu_torch.retrieval import QueryEngine, SearchConfig
from rag_challenge_2_tpu_torch.retrieval.traversal import TraversalResult
from tests import torch_ranks
from tests.conftest import make_reports
from tests.test_torch_engine import _q_for, assert_same_results
from tests.test_torch_sharded_ivf import carry
from tests.torch_engine_traversal_common import (  # noqa: F401  (autouse)
    assert_same_details, drop_compiled_programs, rounded)

METHODS = ("ssg", "triangulation", "hybrid_expansion")
TIERS = ("windowed", "window0")
WORLDS = {"2": {"slice": 1, "device": 2}, "3": {"slice": 1, "device": 3},
          "4": {"slice": 1, "device": 4}, "2x2": {"slice": 2, "device": 2}}
TEXTS = ["营业收入 chunk5", "页面3 chunk7 金盘科技"]
PER_DOC = 370
TIMEOUT = 120               # seconds a world may take (launch.run_ranks)


def _kw(method, tier, bm25=True, **extra):
    # each tier gets a top_n of its own: the JAX engine reads the window
    # when it traces, and a cached trace of the other tier would answer
    return dict(method=method, top_k=5, top_n=60 + TIERS.index(tier), max_hops=3,
                neighbor_k=5, use_bm25=bm25, bm25_top_k=12, **extra)


def _corpus(rng):
    return make_reports(rng, companies=("金盘科技",) * 3, years=(2022, 2023, 2024),
                        pages_per_doc=37, chunks_per_page=10)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The f32, bf16 and int8 stores of one corpus, saved, and the queries:
    three queries near chunks of the three documents."""
    rng = np.random.default_rng(0)
    reports, embs = _corpus(rng)
    root = tmp_path_factory.mktemp("shtrav")
    idx = {"float32": jax_build(reports, embs, vocab_bits=16),
           "bfloat16": jax_build(reports, embs, vocab_bits=16, dtype=jnp.bfloat16)}
    idx["int8"] = (jax_quantize_index(idx["float32"][0]), idx["float32"][1])
    paths = {}
    for store, (i, m) in idx.items():
        paths[store] = str(root / f"{store}.npz")
        jax_save(paths[store], i, m)
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 7, rng),
                        _q_for(embs, 2, 300, rng)])
    return dict(idx=idx, paths=paths, q=q, embs=embs)


def _calls(q, tier, **extra):
    """Each method with BM25 for two routes (every document; the one of
    2024), and without BM25 for every document: the JAX engine keeps
    other rows at a tied BM25 cut-off (ROADMAP C), and this corpus's
    chunks share their BM25 scores, so only the calls without BM25 are
    held against it."""
    return [(q, years, _kw(m, tier, bm25, **extra), TEXTS) for m in METHODS
            for years, bm25 in ((None, True), ([2024], True), (None, False))]


def _pick(calls, got, **want):
    """The (call, result) pairs whose SearchConfig kwargs match ``want``."""
    return [(c, g) for c, g in zip(calls, got)
            if all(c[2][k] == v for k, v in want.items())]


def _ranks(world):
    return WORLDS[world]["slice"] * WORLDS[world]["device"]


def _world(n_ranks, jobs):
    return launch.run_ranks(torch_ranks.traversal_cases, n_ranks, "gloo", "cpu",
                            (jobs,), timeout=TIMEOUT)


def _tier_jobs(corpus, world, store="float32"):
    return [dict(index_path=corpus["paths"][store], axes=WORLDS[world],
                 calls=_calls(corpus["q"], tier), window0=tier == "window0")
            for tier in TIERS]


@pytest.fixture(scope="module")
def world2(corpus):
    """A world of 2 ranks over one ``device`` axis: both tiers."""
    return dict(tiers=_world(2, _tier_jobs(corpus, "2")))


@pytest.fixture(scope="module")
def world3(corpus):
    """A world of 3 ranks over one ``device`` axis (the rows do not
    divide): both tiers."""
    return dict(tiers=_world(3, _tier_jobs(corpus, "3")))


@pytest.fixture(scope="module")
def world4(corpus):
    """A world of 4 ranks: both tiers over ``device`` 4 and over the 2 x 2
    mesh; on the 2 x 2 mesh also the bf16 and int8 stores, ``search_many``
    of three requests a method, and ``hybrid_expansion`` over a ShardedIVF
    at nprobe = K."""
    rng = np.random.default_rng(1)
    embs = corpus["embs"]
    qs = [np.concatenate([_q_for(embs, d % 3, (40 * r + d) % PER_DOC, rng)
                          for d in range(1 + r % 3)]) for r in range(3)]
    texts = [TEXTS[: 1 + r % 2] for r in range(3)]
    jobs = _tier_jobs(corpus, "4") + _tier_jobs(corpus, "2x2")
    jobs += [dict(index_path=corpus["paths"][s], axes=WORLDS["2x2"],
                  calls=_calls(corpus["q"], "windowed")) for s in ("bfloat16", "int8")]
    jobs += [dict(index_path=corpus["paths"]["float32"], axes=WORLDS["2x2"], calls=[],
                  many=(qs, None, _kw(m, "windowed"), texts)) for m in METHODS]
    idx, _ = corpus["idx"]["float32"]
    sivf = jax_build_sharded(idx.emb, jax_mesh({"data": 4}), n_clusters=2, iters=5,
                             valid=idx.valid)
    jobs.append(dict(index_path=corpus["paths"]["float32"], axes=WORLDS["2x2"],
                     ivf_arrays=carry(sivf), calls=_ivf_calls(corpus["q"])))
    out = _world(4, jobs)
    return dict(tiers=out[:2], grid_tiers=out[2:4],
                stores=dict(bfloat16=out[4], int8=out[5]),
                many=dict(zip(METHODS, out[6:9])), ivf=out[9], qs=qs, texts=texts,
                sivf=sivf)


def _ivf_calls(q):
    """hybrid_expansion with its basic block from a ShardedIVF at
    nprobe = K = 2 lists a shard."""
    return [c for c in _calls(q, "windowed", use_ivf=True, ivf_nprobe=2)
            if c[2]["method"] == "hybrid_expansion"]


def _details(d):
    """Details of a rank (numpy) as the single-device engine returns them."""
    return {k: TraversalResult(*map(torch.from_numpy, v)) if isinstance(v, tuple)
            else torch.from_numpy(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def single():
    """The single-device port engine's answer to a call, computed once:
    ``single(corpus, call, store, window0) -> (engine, materialized,
    details, materialize_details)``; the worlds share it."""
    engines, answers = {}, {}

    def answer(corpus, call, store="float32", window0=False):
        q, years, kw, texts = call
        key = (store, window0, repr(years), tuple(sorted(kw.items())))
        if key not in answers:
            if (store, window0) not in engines:
                tidx, tmeta = load_index(corpus["paths"][store], device="cpu")
                engines[store, window0] = QueryEngine(tidx, tmeta)
                if window0:
                    engines[store, window0].window = 0
            eng = engines[store, window0]
            cfg = SearchConfig(**kw)
            cands, det = eng.search(q, "金盘科技", "营业收入", years, cfg,
                                    query_texts=texts, with_details=True)
            answers[key] = (eng, eng.materialize(cands, cfg), det,
                            eng.materialize_details(det, cfg))
        return answers[key]

    return answer


def _held(got, want, tol, where):
    """One sharded call's (results, details, materialize_details) against
    ``want``, the same of a reference engine."""
    res, det, md = got
    want_res, want_det, want_md = want
    assert res
    assert_same_results(res, want_res)
    assert_same_details(_details(det), want_det, tol, where)
    assert rounded(md) == rounded(want_md)


def _jax(corpus, call, store="float32", window0=False, ivf=None):
    """The JAX engine's answer to a call: with ``hier=`` on its 8-device
    virtual mesh, or over a ShardedIVF (``ivf``, a flat ``data`` mesh)."""
    q, years, kw, texts = call
    idx, meta = corpus["idx"][store]
    if ivf is None:
        mesh = jax_mesh({"slice": 2, "device": 4})
        grid = NamedSharding(mesh, P(("slice", "device"), None))
        je = JaxEngine(dataclasses.replace(idx, emb=jax.device_put(idx.emb, grid)), meta,
                       hier=(mesh, "slice", "device"))
    else:
        mesh = jax_mesh({"data": 4})
        je = JaxEngine(dataclasses.replace(
            idx, emb=jax.device_put(idx.emb, NamedSharding(mesh, P("data", None))),
            valid=jax.device_put(idx.valid, NamedSharding(mesh, P("data"))),
            sparse=jax_shard_sparse(idx.sparse, 4, mesh=mesh)), meta, ivf=ivf)
    if window0:
        je.window = 0
    cfg = JaxCfg(**kw)
    cands, det = je.search(q, "金盘科技", "营业收入", years, cfg, query_texts=texts,
                           with_details=True)
    return je.materialize(cands, cfg), det, je.materialize_details(det, cfg)


def test_layout_covers_the_cases(corpus):
    """The corpus puts each sharding case into the worlds: a routed
    document spans two ranks in every world, a rank of the 4-rank worlds
    holds none of the routed rows, and 3 ranks do not divide the rows."""
    tidx, _ = load_index(corpus["paths"]["float32"], device="cpu")
    n_pad = tidx.n_pad
    docs = tidx.doc_id.numpy()[tidx.valid.numpy()]
    starts = np.flatnonzero(np.diff(np.concatenate([[-1], docs])))
    ranges = [(s, s + PER_DOC) for s in starts]
    assert len(ranges) == 3 and n_pad == 2048
    for world in WORLDS:
        S = _ranks(world)
        rps = -(-n_pad // S)
        owner = [(lo // rps, (hi - 1) // rps) for lo, hi in ranges]
        assert any(a != b for a, b in owner), world
        held = {r for a, b in owner for r in range(a, b + 1)}
        if S == 4:
            assert len(held) < S
        if S == 3:
            assert n_pad % S != 0


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("world", ["2", "3", "4", "2x2"])
def test_sharded_traversal_matches_single_device(request, corpus, single, world, tier,
                                                 method):
    ranks = request.getfixturevalue(f"world{_ranks(world)}")
    got, _ = ranks["grid_tiers" if world == "2x2" else "tiers"][TIERS.index(tier)]
    for call, g in _pick(_calls(corpus["q"], tier), got, method=method):
        want = single(corpus, call, window0=tier == "window0")[1:]
        _held(g, want, 1e-5, f"{method} {tier} world {world}")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("tier", TIERS)
def test_sharded_traversal_matches_jax(corpus, world4, tier, method):
    got, _ = world4["grid_tiers"][TIERS.index(tier)]
    for call, g in _pick(_calls(corpus["q"], tier), got, method=method, use_bm25=False):
        _held(g, _jax(corpus, call, window0=tier == "window0"), 1e-5,
              f"{method} {tier} jax")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("store", ["bfloat16", "int8"])
def test_sharded_traversal_over_bf16_and_int8_stores(corpus, world4, single, store,
                                                     method):
    """The bf16 store hops through the kernels' plain versions, the int8
    one through the plain hop over dequantized rows; each owner
    dequantizes its own rows."""
    got, _ = world4["stores"][store]
    tol = 1e-4 if store == "int8" else 1e-5
    for call, g in _pick(_calls(corpus["q"], "windowed"), got, method=method):
        _held(g, single(corpus, call, store)[1:], tol, f"{method} {store}")
        if method == "hybrid_expansion" and not call[2]["use_bm25"]:
            _held(g, _jax(corpus, call, store), tol, f"{method} {store} jax")


@pytest.mark.parametrize("method", METHODS)
def test_sharded_search_many(corpus, world4, single, method):
    """``search_many`` of three requests on the sharded engine equals the
    single-device engine's ``search_many`` and its three ``search`` calls."""
    _, many = world4["many"][method]
    eng = single(corpus, _calls(corpus["q"], "windowed")[0])[0]
    cfg = SearchConfig(**_kw(method, "windowed"))
    qs, texts = world4["qs"], world4["texts"]
    want = eng.search_many(qs, "金盘科技", "营业收入", None, cfg, query_texts_list=texts)
    assert len(many) == len(want) == 3
    for r, (got, w) in enumerate(zip(many, want)):
        assert got
        assert_same_results(got, eng.materialize(w, cfg))
        one = eng.search(qs[r], "金盘科技", "营业收入", None, cfg, query_texts=texts[r])
        assert_same_results(got, eng.materialize(one, cfg))


def test_sharded_hybrid_expansion_over_a_sharded_ivf(corpus, world4, single):
    """``use_ivf`` serves hybrid_expansion's basic block from a ShardedIVF
    at nprobe = K (every list probed: exact) and the traversal's hops stay
    exact: the results equal the single-device engine's exact path and the
    JAX engine over its ShardedIVF."""
    got, _ = world4["ivf"]
    for (q, years, kw, texts), g in zip(_ivf_calls(corpus["q"]), got):
        exact = (q, years, dict(kw, use_ivf=False), texts)
        _held(g, single(corpus, exact)[1:], 1e-5, "hybrid_expansion ivf")
        if not kw["use_bm25"]:
            _held(g, _jax(corpus, (q, years, kw, texts), ivf=world4["sivf"]), 1e-5,
                  "hybrid_expansion ivf jax")
