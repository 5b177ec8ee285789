"""``serving/batcher.MicroBatcher`` over the port's engine: concurrent
requests coalesce into ``search_many`` passes whose results equal
unbatched ``QueryEngine.search`` (keys and rep rows equal, scores within
1e-5) and the JAX batcher's over the JAX engine."""

import threading

import numpy as np
import pytest

from rag_challenge_2_tpu.index.store import save_index as jax_save
from rag_challenge_2_tpu.retrieval.engine import QueryEngine as JaxEngine
from rag_challenge_2_tpu.retrieval.engine import SearchConfig as JaxCfg
from rag_challenge_2_tpu.serving.batcher import MicroBatcher as JaxBatcher
from rag_challenge_2_tpu_torch.index import load_index
from rag_challenge_2_tpu_torch.retrieval import QueryEngine, SearchConfig
from rag_challenge_2_tpu_torch.serving import MicroBatcher
from tests.test_torch_engine import _q_for, assert_same_results


@pytest.fixture
def engine(tiny_corpus, tmp_path):
    idx, meta, _, embs = tiny_corpus
    jax_save(tmp_path / "idx.npz", idx, meta)
    tidx, tmeta = load_index(tmp_path / "idx.npz", device="cpu")
    return QueryEngine(tidx, tmeta), embs, JaxEngine(idx, meta)


def _same(a, b):
    assert a.key.tolist() == b.key.tolist()
    assert a.rep_row.tolist() == b.rep_row.tolist()
    np.testing.assert_allclose(a.score.numpy(), b.score.numpy(), rtol=1e-5, atol=1e-5)


def _threads(fn, n, timeout=300):
    errs = []

    def run(i):
        try:
            fn(i)
        except BaseException as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not errs, errs


@pytest.mark.parametrize("method", ["basic", "hybrid_expansion"])
def test_batched_parity_under_threads(engine, rng, method):
    eng, embs, je = engine
    kw = dict(method=method, top_k=5, top_n=40, use_bm25=True, bm25_top_k=12,
              max_hops=2, neighbor_k=5)
    cfg = SearchConfig(**kw)
    batcher = MicroBatcher(eng, max_batch=4, window_ms=30.0)
    jbatcher = JaxBatcher(je, max_batch=4, window_ms=30.0)
    reqs = [(_q_for(embs, d, r, rng), f"doc{d} chunk{r} 营业收入")
            for d, r in [(0, 5), (1, 3), (2, 7), (0, 1)]]
    got, jgot = [None] * len(reqs), [None] * len(reqs)

    def run(i):
        q, text = reqs[i]
        got[i] = batcher.search(q, "金盘科技", question=text, cfg=cfg)
        jgot[i] = jbatcher.search(q, "金盘科技", question=text, cfg=JaxCfg(**kw))

    _threads(run, len(reqs))
    for (q, text), res, jres in zip(reqs, got, jgot):
        _same(res, eng.search(q, "金盘科技", cfg=cfg, query_texts=[text]))
        assert_same_results(eng.materialize(res, cfg), je.materialize(jres, JaxCfg(**kw)))
    assert batcher.stats["requests"] == 4
    assert batcher.stats["batched_requests"] == 4
    assert 1 <= batcher.stats["dispatches"] <= 4


def test_empty_texts_bind_own_question(engine, rng):
    """A follower whose query_texts is an explicit empty list BM25-scores
    its own question, not the batch leader's."""
    eng, embs, _ = engine
    cfg = SearchConfig(method="basic", top_k=5, top_n=10, use_bm25=True)
    batcher = MicroBatcher(eng, max_batch=2, window_ms=50.0)
    q_lead, q_follow = _q_for(embs, 0, 5, rng), _q_for(embs, 1, 3, rng)
    got = {}

    def run(i):
        if i == 0:
            got["lead"] = batcher.search(q_lead, "金盘科技",
                                         question="doc0 chunk5 营业收入", cfg=cfg)
        else:
            got["follow"] = batcher.search(q_follow, "金盘科技",
                                           question="doc1 chunk3 毛利率", cfg=cfg,
                                           query_texts=[])

    _threads(run, 2)
    want = eng.search(q_follow, "金盘科技", question="doc1 chunk3 毛利率", cfg=cfg,
                      query_texts=[])
    _same(got["follow"], want)


def test_single_request_passthrough(engine, rng):
    eng, embs, _ = engine
    cfg = SearchConfig(method="basic", top_k=5, top_n=10)
    batcher = MicroBatcher(eng, max_batch=4, window_ms=1.0)
    q = _q_for(embs, 0, 5, rng)
    _same(batcher.search(q, "金盘科技", cfg=cfg), eng.search(q, "金盘科技", cfg=cfg))
    assert batcher.stats["dispatches"] == 1


@pytest.mark.parametrize("method", ["basic", "ssg"])
def test_overflow_promotes_new_leader(engine, rng, method):
    """More waiters than max_batch: a promoted waiter leads the overflow;
    nothing deadlocks and every request gets its own answer."""
    eng, embs, _ = engine
    cfg = SearchConfig(method=method, top_k=5, top_n=10, max_hops=2, neighbor_k=5)
    batcher = MicroBatcher(eng, max_batch=2, window_ms=50.0)
    rows = [5, 3, 7, 1, 9]
    qs = [_q_for(embs, 0, r, rng) for r in rows]
    got = [None] * len(rows)

    def run(i):
        got[i] = batcher.search(qs[i], "金盘科技", cfg=cfg)

    _threads(run, len(rows))
    for i in range(len(rows)):
        assert got[i] is not None, f"request {i} never completed"
        _same(got[i], eng.search(qs[i], "金盘科技", cfg=cfg))
    assert batcher.stats["batched_requests"] == 5
    assert batcher.stats["dispatches"] >= 3  # ceil(5 / max_batch=2)


def test_distinct_routes_do_not_batch(engine, rng):
    eng, embs, _ = engine
    cfg = SearchConfig(method="basic", top_k=5, top_n=10)
    batcher = MicroBatcher(eng, max_batch=4, window_ms=5.0)
    q1 = _q_for(embs, 0, 5, rng)
    r1 = batcher.search(q1, "金盘科技", selected_years=[2023], cfg=cfg)
    batcher.search(_q_for(embs, 1, 3, rng), "金盘科技", selected_years=[2024], cfg=cfg)
    _same(r1, eng.search(q1, "金盘科技", selected_years=[2023], cfg=cfg))
    assert batcher.stats["dispatches"] == 2


def test_equivalent_routes_share_a_dispatch(engine, rng):
    """Groups key on the resolved route: [2023] and [2022, 2023] resolve to
    the same document, so they may ride one dispatch."""
    eng, embs, _ = engine
    cfg = SearchConfig(method="basic", top_k=5, top_n=10)
    batcher = MicroBatcher(eng, max_batch=4, window_ms=60.0)
    assert (eng.routed_docs("金盘科技", selected_years=[2023])
            == eng.routed_docs("金盘科技", selected_years=[2022, 2023]))
    reqs = [(_q_for(embs, 0, 5, rng), [2023]), (_q_for(embs, 0, 3, rng), [2022, 2023])]
    got = [None] * 2

    def run(i):
        q, years = reqs[i]
        got[i] = batcher.search(q, "金盘科技", selected_years=years, cfg=cfg)

    _threads(run, 2)
    for (q, years), res in zip(reqs, got):
        _same(res, eng.search(q, "金盘科技", selected_years=years, cfg=cfg))
    assert 1 <= batcher.stats["dispatches"] <= 2


def test_error_propagates_to_all_waiters(engine, rng):
    eng, embs, _ = engine
    batcher = MicroBatcher(eng, max_batch=4, window_ms=5.0)
    with pytest.raises(ValueError, match="No report found"):
        batcher.search(_q_for(embs, 0, 5, rng), "不存在公司")
    with pytest.raises(ValueError, match="unknown method"):
        batcher.search(_q_for(embs, 0, 5, rng), "金盘科技",
                       cfg=SearchConfig(method="graph"))
    assert batcher._groups == {}


def test_max_batch_one_runs_each_request_alone(engine, rng):
    eng, embs, _ = engine
    cfg = SearchConfig(top_n=5, top_k=8, use_bm25=True, bm25_top_k=8)
    mb = MicroBatcher(eng, max_batch=1, window_ms=50.0)
    q = _q_for(embs, 0, 3, rng)
    direct = eng.search(q, "金盘科技", "营业收入", cfg=cfg, query_texts=["营业收入"])
    results = [None] * 4

    def call(i):
        results[i] = mb.search(q, "金盘科技", "营业收入", cfg=cfg,
                               query_texts=["营业收入"])

    _threads(call, 4)
    for r in results:
        _same(r, direct)
    assert mb.stats["dispatches"] == mb.stats["requests"] == 4


def test_full_batch_rides_one_dispatch(engine, rng):
    """The batcher coalesces whatever the corpus size: three requests that
    arrive together fill ``max_batch`` and share one ``search_many``."""
    eng, embs, _ = engine
    mb = MicroBatcher(eng, max_batch=3, window_ms=2000.0)
    cfg = SearchConfig(top_n=5, top_k=8, use_bm25=True, bm25_top_k=8)
    q = _q_for(embs, 0, 3, rng)
    direct = eng.search(q, "金盘科技", "营业收入", cfg=cfg, query_texts=["营业收入"])
    barrier = threading.Barrier(3)
    results = [None] * 3

    def call(i):
        barrier.wait()
        results[i] = mb.search(q, "金盘科技", "营业收入", cfg=cfg,
                               query_texts=["营业收入"])

    _threads(call, 3)
    for r in results:
        _same(r, direct)
    assert mb.stats["batched_requests"] == 3
    assert mb.stats["dispatches"] == 1
