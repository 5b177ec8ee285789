"""The program's own spans laid over the profiler's trace.

The port records spans from inside itself while a collection is started
(``rag_challenge_2_tpu_torch/utils/profiling.py``: ``span`` / ``collect``):
a name, a request id, a parent, the thread under both keys the profiler
may give it (``trace.thread_keys``) and its start and end by
``time.time_ns``, the clock the profiler's events are tied to.  Given
the kineto events of a traced window and those records:

* each idle gap of the device is split over its length by the innermost
  span open on the thread that launched the operation ending the gap;
  time covered by no span of that thread goes to ``outside`` (the client
  or the benchmark).  This replaces, for these numbers only, the
  brackets' rule (``trace.reduce``) of giving a whole gap to whoever
  launched its end;
* each device operation is tied to the innermost span whose thread and
  interval hold its launch.

The span records are read by attribute (``name``, ``request``, ``id``,
``parent``, ``tid``, ``tid_low``, ``t0_ns``, ``t1_ns``, ``attrs``), so
this module imports nothing of the program.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .trace import LAUNCH_PREFIXES

OUTSIDE = "outside"


@dataclass
class ProgramTrace:
    """Idle time by span name (``outside`` when no span was open), idle
    time and device operations credited to each span itself, and how
    many operations were tied to spans."""
    window_s: float = 0.0
    idle_by: Dict[str, float] = field(default_factory=dict)
    gap_s: Dict[int, float] = field(default_factory=dict)      # span id -> idle s
    ops: Dict[int, int] = field(default_factory=dict)          # span id -> operations
    spans: Dict[int, object] = field(default_factory=dict)     # in the window, by id
    children: Dict[int, List[int]] = field(default_factory=dict)
    device_ops: int = 0
    unlinked: int = 0          # operations whose launch the trace lacks
    unlinked_by: Dict[str, int] = field(default_factory=dict)   # by operation name
    tied: int = 0              # operations tied to a span of their launching thread
    # by span-name prefix: operations launched inside such a span (on a
    # thread the spans know, inside one of its own; on a thread they do
    # not know, inside any by time alone) and those tied to such a span
    # or one below it
    inside_by: Dict[str, Tuple[int, int]] = field(default_factory=dict)

    def total(self, sid: int, per_span: Dict[int, float]) -> float:
        """``per_span`` of span ``sid`` and every span below it."""
        out, todo = 0.0, [sid]
        while todo:
            s = todo.pop()
            out += per_span.get(s, 0)
            todo += self.children.get(s, ())
        return out

    def named(self, name: str) -> List[object]:
        return [sp for sp in self.spans.values() if sp.name == name]


class _Thread:
    """One thread's spans as segments ``[start, end)`` of the innermost
    open span (None where none is)."""

    def __init__(self, spans: Sequence[object]):
        segs: List[Tuple[int, int, Optional[object]]] = []
        stack: List[object] = []
        cur: Optional[int] = None

        def close_to(t: int) -> None:
            nonlocal cur
            while stack and stack[-1].t1_ns <= t:
                top = stack.pop()
                if top.t1_ns > cur:
                    segs.append((cur, top.t1_ns, top))
                    cur = top.t1_ns

        for sp in sorted(spans, key=lambda s: (s.t0_ns, -s.t1_ns)):
            if cur is None:
                cur = sp.t0_ns
            close_to(sp.t0_ns)
            if sp.t0_ns > cur:
                segs.append((cur, sp.t0_ns, stack[-1] if stack else None))
                cur = sp.t0_ns
            stack.append(sp)
        if stack:
            close_to(max(sp.t1_ns for sp in stack))
        self.segs = segs
        self.starts = [s[0] for s in segs]

    def at(self, t: int) -> Optional[object]:
        """The innermost span open at ``t``."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return None

    def split(self, a: int, b: int):
        """``(span or None, ns)`` covering ``[a, b)``."""
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        t = a
        while t < b and i < len(self.segs):
            s0, s1, sp = self.segs[i]
            if s1 <= t:
                i += 1
                continue
            if s0 > t:
                yield None, min(s0, b) - t
                t = min(s0, b)
                continue
            e = min(s1, b)
            yield sp, e - t
            t = e
            i += 1
        if t < b:
            yield None, b - t


def reduce_program(events, t0_ns: int, t1_ns: int, spans: Sequence[object],
                   prefixes: Sequence[str] = ("dense.", "")) -> ProgramTrace:
    """Lay ``spans`` over the kineto ``events`` of the window ``[t0_ns,
    t1_ns]`` (see the module docstring)."""
    dev_ops, launches = [], {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s = e.start_ns()
            dev_ops.append((s, s + e.duration_ns(), e.correlation_id(), e.name()))
        elif e.name().startswith(LAUNCH_PREFIXES):
            launches[e.correlation_id()] = (e.device_resource_id(), e.start_ns())
    pt = ProgramTrace(window_s=(t1_ns - t0_ns) / 1e9)
    inside = [sp for sp in spans if sp.t0_ns >= t0_ns and sp.t1_ns <= t1_ns]
    pt.spans = {sp.id: sp for sp in inside}
    for sp in inside:
        if sp.parent in pt.spans:
            pt.children.setdefault(sp.parent, []).append(sp.id)
    by_keys: Dict[Tuple[int, int], List[object]] = defaultdict(list)
    for sp in spans:              # the whole record: a window may start inside a span
        by_keys[sp.tid, sp.tid_low].append(sp)
    threads: Dict[int, _Thread] = {}
    for keys, group in by_keys.items():
        th = _Thread(group)
        for k in keys:
            threads[k] = th

    def credit(sp) -> bool:
        return sp is not None and sp.id in pt.spans

    idle: Dict[str, float] = defaultdict(float)
    gap_s: Dict[int, float] = defaultdict(float)
    ops: Dict[int, int] = defaultdict(int)
    dev_ops.sort()
    cur_e = t0_ns
    tied_span: Dict[int, object] = {}
    unlinked: Dict[str, int] = defaultdict(int)
    for s, e, corr, name in dev_ops:
        s_c, e_c = max(s, t0_ns), min(e, t1_ns)
        if e_c <= s_c:
            continue
        pt.device_ops += 1
        la = launches.get(corr)
        th = threads.get(la[0]) if la is not None else None
        if la is None:
            pt.unlinked += 1
            unlinked[name] += 1
        sp = th.at(la[1]) if th is not None else None
        if sp is not None:
            tied_span[corr] = sp
            pt.tied += 1
            if credit(sp):
                ops[sp.id] += 1
        if s_c > cur_e:                 # a gap [cur_e, s_c) ended by this operation
            if th is None:
                idle[OUTSIDE] += (s_c - cur_e) / 1e9
            else:
                for g_sp, ns in th.split(cur_e, s_c):
                    idle[g_sp.name if g_sp is not None else OUTSIDE] += ns / 1e9
                    if credit(g_sp):
                        gap_s[g_sp.id] += ns / 1e9
        cur_e = max(cur_e, e_c)
    idle[OUTSIDE] += max(0, t1_ns - cur_e) / 1e9
    pt.idle_by, pt.gap_s, pt.ops = dict(idle), dict(gap_s), dict(ops)
    pt.unlinked_by = dict(unlinked)

    # by prefix: launched inside such a span, and tied to one
    by_id = {sp.id: sp for sp in spans}

    def under(sp, prefix: str) -> bool:
        while sp is not None:
            if sp.name.startswith(prefix):
                return True
            sp = by_id.get(sp.parent)
        return False

    for prefix in prefixes:
        ivals = _union([(sp.t0_ns, sp.t1_ns) for sp in spans if sp.name.startswith(prefix)])
        starts = [a for a, _ in ivals]
        n_in = n_tied = 0
        for s, e, corr, _ in dev_ops:
            la = launches.get(corr)
            if la is None or not (t0_ns <= s <= t1_ns):
                continue
            if la[0] in threads:
                launched_in = under(threads[la[0]].at(la[1]), prefix)
            else:
                i = bisect.bisect_right(starts, la[1]) - 1
                launched_in = i >= 0 and la[1] <= ivals[i][1]
            n_in += launched_in
            n_tied += launched_in and under(tied_span.get(corr), prefix)
        pt.inside_by[prefix] = (n_in, n_tied)
    return pt


def _union(ivals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(ivals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def host_gap_ms(pt: Optional[ProgramTrace], name: str = "dense.topk") -> Optional[float]:
    """The median over the window's ``name`` spans of the device's idle
    time inside each (its own share of the split and its children's), in
    ms; None without a device trace that tied an operation to a span."""
    if pt is None or not pt.tied:
        return None
    s = [pt.total(sp.id, pt.gap_s) * 1e3 for sp in pt.named(name)]
    return statistics.median(s) if s else None


def ops_per_call(pt: Optional[ProgramTrace], name: str = "dense.topk") -> Optional[float]:
    """The median over the window's ``name`` spans of the device
    operations tied to each or to a span below it."""
    if pt is None or not pt.tied:
        return None
    s = [pt.total(sp.id, pt.ops) for sp in pt.named(name)]
    return float(statistics.median(s)) if s else None


def durations_ms(spans: Sequence[object], name: str, per: Optional[str] = None) -> List[float]:
    """The host durations of the spans called ``name``, in ms (each over
    its attribute ``per`` where it has one: a span that serves several
    requests)."""
    return [(sp.t1_ns - sp.t0_ns) / 1e6 / max(1, int(sp.attrs.get(per, 1) if per else 1))
            for sp in spans if sp.name == name]


def queue_wait_ms(spans: Optional[Sequence[object]]) -> Optional[float]:
    """The median ``batcher.wait``: from a request's enqueueing to its
    dispatch's start."""
    s = durations_ms(spans or (), "batcher.wait")
    return statistics.median(s) if s else None


def prepare_ms(spans: Optional[Sequence[object]]) -> Optional[float]:
    """The median ``engine.prepare`` time per request it prepares."""
    s = durations_ms(spans or (), "engine.prepare", per="count")
    return statistics.median(s) if s else None


def summary(pt: ProgramTrace, n: int = 12) -> str:
    """One log line: idle seconds by span, and the operations tied."""
    idle = sorted(pt.idle_by.items(), key=lambda kv: -kv[1])[:n]
    inside = "; ".join(f"{p or 'any'}: {t} of {i}" for p, (i, t) in pt.inside_by.items())
    lost = sorted(pt.unlinked_by.items(), key=lambda kv: -kv[1])[:3]
    return (f"program spans: idle s by innermost span {[[k, round(v, 6)] for k, v in idle]}; "
            f"{pt.device_ops} device operations, {pt.tied} tied to a span, "
            f"{pt.unlinked} without their launch {lost}; launched inside / tied by prefix: "
            f"{inside}")
