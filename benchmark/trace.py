"""The traced run's brackets and the reduction of its profiler trace.

Brackets are set from the benchmark's side, around the module attributes
the engine calls (``retrieval.engine.dense_hits``, ``bm25_hits``,
``fuse_blocks``, ``QueryEngine.search_many``) or around the scan's entry
call: each records its thread, its start and end on the profiler's clock
(``time.time_ns``) and its host seconds; a dense bracket also records
the work of the call (``roofline.DenseWork``, ``roofline.ModelWork``) and
a BM25 bracket two CUDA events on the current stream.  Spans inside the
program are ``program_trace.py``'s.

The profiler (``torch.profiler``) runs over the traced part of the
window.  Each device operation is tied to the runtime call that launched
it; a kernel counts for a bracket when its launch came from the
bracket's thread while the bracket was open.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from .roofline import DenseWork, ModelWork


def thread_keys() -> Tuple[int, int]:
    """The calling thread under both names the profiler gives a runtime
    call's thread: its native id, and the low 32 bits of its POSIX thread
    handle as a signed 32-bit number."""
    low = threading.get_ident() & 0xFFFFFFFF
    return threading.get_native_id(), low - (1 << 32) if low >= 1 << 31 else low


@dataclass
class Span:
    name: str
    tids: Tuple[int, int]
    t0_ns: int
    t1_ns: int
    host_s: float
    work: Optional[Union[DenseWork, ModelWork]] = None
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None


@dataclass
class Spans:
    spans: List[Span] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _undo: List[Tuple[object, str, object]] = field(default_factory=list)

    def bracket(self, name: str, fn: Callable, work: Optional[Callable] = None,
                events: bool = False) -> Callable:
        """``fn`` wrapped in a bracket called ``name``; ``work(*args,
        **kw)`` gives its dense work, ``events`` adds CUDA events."""
        def wrapped(*args, **kw):
            ev = None
            if events:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0, h0 = time.time_ns(), time.perf_counter()
            out = fn(*args, **kw)
            h1, t1 = time.perf_counter(), time.time_ns()
            if ev is not None:
                ev[1].record()
            span = Span(name, thread_keys(), t0, t1, h1 - h0,
                        work(*args, **kw) if work is not None else None, ev)
            with self._lock:
                self.spans.append(span)
            return out
        return wrapped

    def wrap(self, owner, attr: str, name: str, **kw) -> None:
        """Replace ``owner.attr`` by its bracket until :meth:`restore`."""
        fn = getattr(owner, attr)
        self._undo.append((owner, attr, fn))
        setattr(owner, attr, self.bracket(name, fn, **kw))

    def restore(self) -> None:
        while self._undo:
            owner, attr, fn = self._undo.pop()
            setattr(owner, attr, fn)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


@dataclass
class Trace:
    """What the traced window holds: its length, the device's busy time
    (the union of device operations), device time by operation name, idle
    time by what the host was doing, and device time of the kernels each
    bracket launched."""
    window_s: float = 0.0
    busy_s: float = 0.0
    by_op: Dict[str, float] = field(default_factory=dict)
    idle_by: Dict[str, float] = field(default_factory=dict)
    bracket_device_s: Dict[str, float] = field(default_factory=dict)
    bracket_work_s: Dict[str, float] = field(default_factory=dict)
    bracket_calls: Dict[str, int] = field(default_factory=dict)   # tied to the trace
    bracket_flops: Dict[str, float] = field(default_factory=dict)  # every call in the window
    bracket_peak_s: Dict[str, float] = field(default_factory=dict)  # those at the type's peak
    kernels: int = 0
    unlinked: int = 0          # device operations whose launch the trace lacks
    threads: Tuple[int, int, int] = (0, 0, 0)   # launching, bracketed, both
    brackets_in_window: int = 0


LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def reduce(events, t0_ns: int, t1_ns: int, spans: Spans,
           priority: Tuple[str, ...]) -> Trace:
    """Reduce the profiler's kineto events over ``[t0_ns, t1_ns]``.  An
    idle gap is put down to the first bracket in ``priority`` open on the
    thread that launched the operation ending it, or to ``host`` when none
    is (or when nothing ends it within the window)."""
    dev_ops, launches = [], {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s = e.start_ns()
            dev_ops.append((s, s + e.duration_ns(), e.name(), e.correlation_id()))
        elif e.name().startswith(LAUNCH_PREFIXES):
            # a runtime call: its correlation id is its device operation's,
            # its resource id the launching thread's
            launches[e.correlation_id()] = (e.device_resource_id(), e.start_ns())
    tr = Trace(window_s=(t1_ns - t0_ns) / 1e9)
    dev_ops.sort()
    # the union of device intervals inside the window, and the gaps between
    busy, gap_end, cur_s, cur_e = 0, {}, t0_ns, t0_ns
    by_op: Dict[str, float] = defaultdict(float)
    for s, e, name, _ in dev_ops:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        by_op[name] += (e - s) / 1e9
        tr.kernels += 1
        if s > cur_e:
            busy += cur_e - cur_s
            gap_end[s] = cur_e          # a gap ends where an operation starts
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    tr.busy_s, tr.by_op = busy / 1e9, dict(by_op)
    # the brackets wholly inside the window, by name and launching thread
    by_thread: Dict[Tuple[str, int], List[Span]] = defaultdict(list)
    inside_window = [sp for sp in spans.spans if sp.t0_ns >= t0_ns and sp.t1_ns <= t1_ns]
    for sp in inside_window:
        for tid in set(sp.tids):
            by_thread[sp.name, tid].append(sp)
    names_of: Dict[int, List[str]] = defaultdict(list)
    for bname, btid in by_thread:
        names_of[btid].append(bname)
    starts = {key: [sp.t0_ns for sp in v] for key, v in by_thread.items()}

    def open_on_thread(tid: int, t: int) -> List[Span]:
        out = []
        for bname in names_of.get(tid, ()):
            i = bisect.bisect_right(starts[bname, tid], t) - 1
            if i >= 0 and t <= by_thread[bname, tid][i].t1_ns:
                out.append(by_thread[bname, tid][i])
        return out

    span_s: Dict[int, float] = defaultdict(float)
    idle: Dict[str, float] = defaultdict(float)
    for s, e, name, corr in dev_ops:
        la = launches.get(corr)
        inside = open_on_thread(*la) if la is not None else []
        if la is None:
            tr.unlinked += t0_ns <= s <= t1_ns
        for sp in inside:
            span_s[id(sp)] += (e - s) / 1e9
        if s in gap_end:
            names = {sp.name for sp in inside}
            label = next((n for n in priority if n in names), "host")
            idle[label] += (s - gap_end.pop(s)) / 1e9
    idle["host"] += max(0, t1_ns - cur_e) / 1e9
    tr.idle_by = dict(idle)
    # a bracket counts once the trace tied a device operation to it (a
    # thread the profiler names otherwise drops out of both sums)
    for sp in inside_window:
        if id(sp) not in span_s:
            continue
        n = sp.name
        tr.bracket_calls[n] = tr.bracket_calls.get(n, 0) + 1
        tr.bracket_device_s[n] = tr.bracket_device_s.get(n, 0.0) + span_s[id(sp)]
        if sp.work is not None:
            tr.bracket_work_s[n] = tr.bracket_work_s.get(n, 0.0) + sp.work.least_s()
    for sp in inside_window:
        flops = getattr(sp.work, "flops", None)
        if flops is not None:
            tr.bracket_flops[sp.name] = tr.bracket_flops.get(sp.name, 0.0) + flops
            tr.bracket_peak_s[sp.name] = tr.bracket_peak_s.get(sp.name, 0.0) + sp.work.peak_s()
    tr.brackets_in_window = len(inside_window)
    launching = {tid for tid, t in launches.values() if t0_ns <= t <= t1_ns}
    tids = {sp.tids for sp in inside_window}
    tr.threads = (len(launching), len(tids), sum(1 for k in tids if launching & set(k)))
    return tr


def breakdown(tr: Trace, n: int = 10) -> Dict[str, list]:
    """The device operations that took most time and the idle time by what
    the host was doing, at most ``n`` of each, in seconds."""
    ops = sorted(tr.by_op.items(), key=lambda kv: -kv[1])[:n]
    idle = sorted(tr.idle_by.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}
