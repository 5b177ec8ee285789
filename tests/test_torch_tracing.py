"""The port's spans (``utils/profiling.py``): off by default at the cost of
one flag check, the records they leave when collected, the span trees of
the dense entry and of the served path (a request's id across the
``MicroBatcher``'s threads), and the profiler's clock shared with them."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from rag_challenge_2_tpu_torch.index import build_corpus_index
from rag_challenge_2_tpu_torch.ops.quant import quantize_rows
from rag_challenge_2_tpu_torch.ops.topk import dense_topk
from rag_challenge_2_tpu_torch.retrieval import QueryEngine, SearchConfig
from rag_challenge_2_tpu_torch.serving import MicroBatcher
from rag_challenge_2_tpu_torch.utils import profiling as pf
from tests.conftest import make_reports

COMPANY = "金盘科技"


def keys_of_this_thread():
    low = threading.get_ident() & 0xFFFFFFFF
    return threading.get_native_id(), low - (1 << 32) if low >= 1 << 31 else low


def tree(spans):
    """``{name: [parent name, ...]}`` of the records."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(by_id[s.parent].name if s.parent in by_id else None)
    return out


def test_off_records_nothing_and_returns_the_shared_noop(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("read while tracing is off")

    monkeypatch.setattr(pf.time, "time_ns", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    a = pf.span("dense.topk", request=pf.NEW, queries=3)
    assert a is pf.span("engine.fuse") is pf.request_scope() is pf._NOOP
    with a as sp, pf.request_scope() as rid:
        assert sp is None and rid is None
        pf.note(regime="float")
        pf.record("batcher.wait", 1, 2)
        assert pf.request_id() is None and pf.member(0) is None and pf.now_ns() == 0
    col = pf.collect()
    col.start()
    col.stop()
    with pf.span("after.stop"):
        pass
    assert col.spans == [] and not pf._ON


def test_off_costs_under_a_microsecond_a_span(monkeypatch):
    """What an off span adds to a loop, against the same loop without it,
    timed in turns in each round on this thread's own CPU clock, so that
    the machine's load (other test workers taking the cores) slows
    neither; and the off path reads no clock and makes no object."""
    n = 20_000

    def spans():
        t = time.thread_time_ns()
        for _ in range(n):
            with pf.span("dense.launch"):
                pass
        return time.thread_time_ns() - t

    def bare():
        t = time.thread_time_ns()
        for _ in range(n):
            pass
        return time.thread_time_ns() - t

    assert min((spans() - bare()) / n for _ in range(7)) < 1000

    def boom(*a, **kw):
        raise AssertionError("read while tracing is off")

    monkeypatch.setattr(pf.time, "time_ns", boom)
    assert pf.span("dense.launch", rows=3) is pf._NOOP
    with pf.span("dense.launch"):
        pass


def test_on_records_name_ids_parent_thread_keys_and_times():
    with pf.collect() as spans:
        t_before = time.time_ns()
        with pf.span("outer", request=pf.NEW, rows=7) as outer:
            pf.note(regime="int8_large")
            with pf.span("inner") as inner:
                assert pf.request_id() == outer.request
            with pf.span("other", request=41):
                pass
            pf.record("done.before", t_before, t_before + 1)
        with pf.span("fresh", request=pf.NEW) as fresh:
            pass
        with pf.span("batch", requests=[5, 6]):
            assert (pf.member(0), pf.member(1), pf.member(2)) == (5, 6, None)
            with pf.request_scope(pf.member(1)) as rid, pf.span("member"):
                assert rid == 6
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["inner", "other", "done.before", "outer", "fresh",
                                       "member", "batch"]       # in the order they closed
    assert outer.attrs == {"rows": 7, "regime": "int8_large"}
    assert inner.request == outer.request and inner.parent == outer.id
    assert by["other"].request == 41 and by["other"].parent == outer.id
    assert by["done.before"].parent == outer.id and by["done.before"].t0_ns == t_before
    assert fresh.request not in (None, outer.request) and fresh.parent is None
    assert by["member"].request == 6 and by["member"].parent == by["batch"].id
    assert by["batch"].request is None
    assert len({s.id for s in spans}) == len(spans)
    for s in spans:
        assert (s.tid, s.tid_low) == keys_of_this_thread()
        assert s.t0_ns <= s.t1_ns
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    assert outer.t0_ns >= t_before


def test_collections_nest_and_threads_keep_their_own_stacks():
    outer = pf.collect()
    outer.start()
    got = {}

    def worker():
        with pf.span("worker"):
            got["keys"] = keys_of_this_thread()

    with pf.collect() as inner:
        with pf.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    with pf.span("outer.only"):
        pass
    outer.stop()
    assert [s.name for s in inner] == ["worker", "main"]
    assert [s.name for s in outer.spans] == ["worker", "main", "outer.only"]
    w = inner[0]
    assert w.parent is None and (w.tid, w.tid_low) == got["keys"]


def _store(dtype, n=3000, d=32):
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(3))
    if dtype == "int8":
        codes, scale = quantize_rows(x)
        return codes, scale
    return x.to(getattr(torch, dtype)), None


@pytest.mark.parametrize("dtype,impl,mask,want", [
    ("int8", "auto", False, {"dense.code_queries", "dense.launch"}),
    ("int8", "auto", True, {"dense.code_queries", "dense.launch", "dense.fill"}),
    # 127 queries over a bf16 store take K3 on the card: the blocked scan
    ("bfloat16", "blocked", False, {"dense.code_queries", "dense.launch"}),
    # K1's route (the plain version here)
    ("bfloat16", "auto", False, {"dense.launch"}),
], ids=["int8", "int8-mask", "bf16-k3", "bf16-k1"])
def test_dense_topk_span_tree(dtype, impl, mask, want):
    emb, scale = _store(dtype)
    q = torch.randn(127, emb.shape[1], generator=torch.Generator().manual_seed(4))
    m = (torch.arange(emb.shape[0]) % 3 == 0) if mask else None
    ref = dense_topk(q, emb, 30, mask=m, impl=impl, row_scale=scale)
    with pf.collect() as spans:
        got = dense_topk(q, emb, 30, mask=m, impl=impl, row_scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))     # spans change nothing
    assert len(spans) <= 4                                       # a scan call
    top = [s for s in spans if s.name == "dense.topk"]
    assert len(top) == 1 and top[0].parent is None and top[0].request is not None
    assert top[0].attrs == {"queries": 127, "rows": emb.shape[0], "k": 30,
                            "dtype": dtype, "route": "plain"}
    assert tree(spans) == {"dense.topk": [None], **{n: ["dense.topk"] for n in want}}
    assert {s.request for s in spans} == {top[0].request}
    for s in spans:
        assert top[0].t0_ns <= s.t0_ns <= s.t1_ns <= top[0].t1_ns


@pytest.fixture
def engine(rng):
    reports, embs = make_reports(rng)
    idx, meta = build_corpus_index(reports, embs, device="cpu")
    return QueryEngine(idx, meta), embs


CFG = SearchConfig(top_k=5, top_n=20, use_bm25=True, bm25_top_k=8)
ENGINE_SPANS = {"engine.prepare": [None], "engine.route": ["engine.prepare"],
                "engine.tokenize": ["engine.prepare"], "engine.upload": ["engine.prepare"]}


def test_engine_search_spans_share_one_request(engine):
    eng, embs = engine
    with pf.collect() as spans:
        eng.search(embs[0][:2], COMPANY, question="营业收入", cfg=CFG)
    t = tree(spans)
    assert {k: t[k] for k in ENGINE_SPANS} == ENGINE_SPANS
    assert t["engine.dense"] == [None] and t["engine.bm25"] == [None]
    assert t["engine.fuse"] == [None]
    assert set(t["dense.topk"]) == {"engine.dense"}      # one a routed document slot
    assert len({s.request for s in spans}) == 1 and spans[0].request is not None
    assert [s.attrs for s in spans if s.name == "engine.prepare"] == [{"count": 1}]


def test_search_many_prepares_every_request_under_one_span(engine):
    eng, embs = engine
    with pf.collect() as spans:
        eng.search_many([embs[0][:1], embs[0][1:3]], COMPANY, question="营业收入", cfg=CFG)
    names = [s.name for s in spans]
    assert names.count("engine.prepare") == 1 and names.count("engine.route") == 1
    assert names.count("engine.tokenize") == names.count("engine.upload") == 2
    assert names.count("engine.fuse") == 2
    assert [s.attrs for s in spans if s.name == "engine.prepare"] == [{"count": 2}]
    assert len({s.request for s in spans}) == 1


def test_batcher_follower_request_id_reaches_the_leader(engine):
    """Two threads, one dispatch: the follower's ``batcher.wait`` is on its
    own thread, and the leader's ``batcher.dispatch`` and its request's
    ``engine.*`` spans carry the follower's id."""
    eng, embs = engine
    batcher = MicroBatcher(eng, max_batch=2, window_ms=10_000.0)
    out, keys = {}, {}

    def ask(i):
        keys[i] = keys_of_this_thread()
        out[i] = batcher.search(embs[0][i:i + 1], COMPANY, question="营业收入", cfg=CFG)

    with pf.collect() as spans:
        lead = threading.Thread(target=ask, args=(0,))
        lead.start()
        deadline = time.monotonic() + 30
        while not batcher._groups and time.monotonic() < deadline:
            time.sleep(0.001)
        follow = threading.Thread(target=ask, args=(1,))
        follow.start()
        for t in (lead, follow):
            t.join(timeout=120)
    assert not lead.is_alive() and not follow.is_alive() and set(out) == {0, 1}
    assert batcher.stats == {"dispatches": 1, "requests": 2, "batched_requests": 2}
    (dispatch,) = [s for s in spans if s.name == "batcher.dispatch"]
    waits = {(s.tid, s.tid_low): s for s in spans if s.name == "batcher.wait"}
    assert set(waits) == {keys[0], keys[1]}
    lw, fw = waits[keys[0]], waits[keys[1]]
    assert (dispatch.tid, dispatch.tid_low) == keys[0]
    assert dispatch.attrs == {"count": 2, "requests": [lw.request, fw.request]}
    assert dispatch.request == lw.request != fw.request
    assert lw.t1_ns == fw.t1_ns <= dispatch.t0_ns and lw.t0_ns <= fw.t0_ns
    by_id = {s.id: s for s in spans}

    def root(s):
        while s.parent in by_id:
            s = by_id[s.parent]
        return s

    follower = [s for s in spans if s.request == fw.request and s is not fw]
    assert {s.name for s in follower} == {"engine.tokenize", "engine.upload", "engine.fuse"}
    for s in follower:
        assert (s.tid, s.tid_low) == keys[0] and root(s) is dispatch
    for s in spans:
        if s.name.startswith(("engine.", "dense.")):
            assert root(s) is dispatch, s.name
    assert fw.parent is None and lw.parent is None


@pytest.mark.parametrize("regions", [False, True], ids=["plain", "regions"])
def test_spans_share_the_profilers_clock(regions):
    """A torch op's profiler event lies inside the span around it, on the
    span's thread; a plain collection adds no region to the trace (the
    profiler would give a region a device-side event), one with
    ``regions`` does."""
    a = torch.randn(256, 256)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof, pf.collect(regions) as spans:
        with pf.span("clock.check"):
            a @ a
    (sp,) = spans
    events = prof.profiler.kineto_results.events()
    mm = [e for e in events if e.name() == "aten::mm"]
    region = [e for e in events if e.name() == "clock.check"]
    assert mm and len(region) == int(regions)
    for e in mm + region:
        assert sp.t0_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= sp.t1_ns
        assert e.device_resource_id() in (sp.tid, sp.tid_low)


def test_device_trace_holds_a_program_span(tmp_path):
    emb, scale = _store("int8")
    with pf.device_trace(tmp_path, "outer"):
        with pf.annotate("inner"):
            dense_topk(torch.randn(4, emb.shape[1]), emb, 5, row_scale=scale)
    names = {e.get("name") for e in json.loads(
        (tmp_path / "outer.json").read_text())["traceEvents"]}
    assert {"outer", "inner", "dense.topk", "dense.launch"} <= names
    assert not pf._ON


def test_results_unchanged_by_tracing_on_the_served_path(engine):
    eng, embs = engine
    q = np.asarray(embs[1][:3])
    off = eng.search(q, COMPANY, question="净利润", cfg=CFG)
    with pf.collect():
        on = eng.search(q, COMPANY, question="净利润", cfg=CFG)
    assert torch.equal(off.key, on.key) and torch.equal(off.score, on.score)
