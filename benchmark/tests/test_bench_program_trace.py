"""The program's spans over a trace (``program_trace.py``): idle gaps split
by time over the innermost span of the launching thread, operations tied
to spans, and the served numbers read from a tiny served loop's spans."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program_trace
from benchmark.program_trace import (OUTSIDE, host_gap_ms, ops_per_call, prepare_ms,
                                     queue_wait_ms, reduce_program)

from .conftest import tiny
from .test_bench_trace import CPU, CUDA, Ev


def rec(name, sid, parent, tids, t0, t1, request=1, **attrs):
    return SimpleNamespace(name=name, id=sid, parent=parent, tid=tids[0], tid_low=tids[1],
                           t0_ns=t0, t1_ns=t1, request=request, attrs=attrs)


A, B = (7, 70), (9, 90)       # the client's thread; a follower waiting meanwhile

SPANS = [
    rec("dense.topk", 1, None, A, 100, 400),
    rec("dense.code_queries", 2, 1, A, 120, 200),
    rec("dense.launch", 3, 1, A, 250, 380),
    rec("batcher.wait", 4, None, B, 0, 1000, request=2),
]
EVENTS = [
    Ev(CPU, "cudaLaunchKernel", 150, 5, 1, 70),      # in the coding span (handle key)
    Ev(CUDA, "abs", 210, 20, 1),
    Ev(CPU, "cudaLaunchKernel", 300, 5, 2, 7),       # in the launch span (native id)
    Ev(CUDA, "scan", 390, 510, 2),
    Ev(CPU, "cudaLaunchKernel", 310, 5, 5, 11),      # a thread no span knows
    Ev(CUDA, "stray", 905, 10, 5),
    Ev(CPU, "cuMemcpyAsync", 950, 5, 3, 7),          # the client's copy, outside spans
    Ev(CUDA, "copy", 1000, 50, 3),
    Ev(CUDA, "lost", 1100, 10, 4),                   # its launch is not in the trace
]


def test_gap_split_by_time_over_the_innermost_span():
    pt = reduce_program(EVENTS, 0, 1200, SPANS)
    # [0, 210) ends with the coding kernel: 100 before the call, 20 + 10 in
    # dense.topk itself, 80 coding; [230, 390) ends with the scan: 20 + 10 in
    # dense.topk, 130 in the launch; [900, 905) the stray one, from a thread
    # no span knows; [915, 1000) the copy launched outside; [1050, 1100)
    # unlinked; [1110, 1200) the window's end.  The follower's open wait
    # takes none of it: no operation was launched on its thread.
    assert pt.idle_by == pytest.approx({OUTSIDE: 330e-9, "dense.topk": 60e-9,
                                        "dense.code_queries": 80e-9,
                                        "dense.launch": 130e-9})
    assert pt.gap_s == pytest.approx({1: 60e-9, 2: 80e-9, 3: 130e-9})
    assert pt.ops == {2: 1, 3: 1}
    assert (pt.device_ops, pt.tied, pt.unlinked) == (5, 2, 1)
    assert pt.unlinked_by == {"lost": 1}
    # the stray launch lies, by time, inside the call's spans but on a
    # thread they do not know: launched inside, tied to none.  The copy's
    # thread is known and had no span open: not inside.
    assert pt.inside_by == {"dense.": (3, 2), "": (3, 2)}
    assert host_gap_ms(pt) == pytest.approx(270e-6)
    assert ops_per_call(pt) == 2
    assert "dense.launch" in program_trace.summary(pt)


def test_ops_per_call_is_a_median_over_calls():
    spans, events = [], []
    for c in range(3):                  # calls of 1, 3 and 5 operations
        base = 1000 * c
        spans += [rec("dense.topk", 10 * c + 1, None, A, base, base + 500),
                  rec("dense.launch", 10 * c + 2, 10 * c + 1, A, base + 100, base + 400)]
        for j in range(2 * c + 1):
            corr = 100 * c + j
            events += [Ev(CPU, "cudaLaunchKernel", base + 110 + j, 1, corr, 7),
                       Ev(CUDA, "k", base + 200 + 10 * j, 5, corr)]
    pt = reduce_program(events, 0, 3000, spans)
    assert ops_per_call(pt) == 3
    assert pt.inside_by["dense."] == (9, 9)


def test_no_device_trace_reads_none():
    pt = reduce_program([], 0, 1000, SPANS)
    assert host_gap_ms(pt) is None and ops_per_call(pt) is None
    assert host_gap_ms(None) is None and ops_per_call(None) is None
    assert pt.idle_by == {OUTSIDE: 1e-6}
    assert queue_wait_ms(None) is None and prepare_ms([]) is None


def test_spans_outside_the_window_are_not_calls():
    pt = reduce_program(EVENTS, 200, 1200, SPANS)
    assert pt.named("dense.topk") == []
    assert host_gap_ms(pt) is None
    # the gap inside the window still goes to the span open then
    assert pt.idle_by["dense.launch"] == pytest.approx(130e-9)


def test_served_numbers_from_spans():
    spans = [rec("batcher.wait", 1, None, A, 0, 2_000_000),
             rec("batcher.wait", 2, None, B, 500_000, 2_000_000),
             rec("batcher.wait", 3, None, B, 0, 4_000_000),
             rec("engine.prepare", 4, None, A, 0, 3_000_000, count=2),
             rec("engine.prepare", 5, None, A, 0, 500_000, count=1),
             rec("engine.prepare", 6, None, A, 0, 1_000_000, count=1)]
    assert queue_wait_ms(spans) == 2.0
    assert prepare_ms(spans) == 1.0


def test_tiny_served_loop_through_the_batcher():
    """Two clients through ``entry: batcher`` with the program's spans
    collected: the wait, the dispatches' size and prepare all read."""
    from rag_challenge_2_tpu_torch.utils import profiling

    cell = "flat1p5m_bf16.hybrid_c1"
    cfg, mix, limits = tiny(cell)
    mix = dict(mix, entry="batcher", clients=2,
               batcher={"max_batch": 4, "window_ms": 4.0})
    with profiling.collect() as spans:
        res = harness.run_cell(cell, cfg, mix, limits, 2**31 + 77, 0.5, False,
                               torch.device("cpu"), time.perf_counter(), lambda *a: None)
    run = res["run"]
    assert run.batcher["dispatches"] > 0
    per_dispatch = run.batcher["batched_requests"] / run.batcher["dispatches"]
    assert 1 <= per_dispatch <= 4
    assert queue_wait_ms(spans) > 0 and prepare_ms(spans) > 0
    dispatches = [s for s in spans if s.name == "batcher.dispatch"]
    waits = [s for s in spans if s.name == "batcher.wait"]
    assert len(waits) == sum(s.attrs["count"] for s in dispatches)
    assert {s.request for s in waits} == {r for s in dispatches for r in s.attrs["requests"]}
    assert all(res["numbers"][n] <= lim for n, lim in limits["limits"].items())
