#!/usr/bin/env python3
"""One benchmark cell run with the program's own spans collected.

    python3 scripts/trace_cell.py --workload <cell> --seed N --seconds S \\
        --mode traced|spans|off [--mix '{"entry": "batcher", "clients": 8}'] \\
        [--cfg '{"rows": 24000}'] [--device cpu]
    python3 scripts/trace_cell.py --span-cost

It runs a cell of ``BENCHMARK.json`` (or an unlisted one, as
``benchmark/run.py`` does) through ``benchmark.harness.run_cell`` on the
card, with the port's span collection (``utils/profiling.collect``)
started:

* ``traced``: the benchmark's traced run (``--trace 1``: the profiler and
  the brackets), with the spans collected between the profiler's start
  and stop.  It prints the harness's result line (every per-layer metric
  listed for the cell), then one line ``{"program": ...}`` with the
  numbers of ``benchmark/program_trace.py``: ``dense.host_gap_ms``,
  ``dense.ops_per_call``, ``batcher.queue_wait_ms``,
  ``batcher.requests_per_dispatch``, ``engine.prepare_ms``, the idle
  seconds by innermost span and ``outside``, and how many device
  operations were tied to spans of those launched inside them;
* ``spans``: the untraced run (``--trace 0``) with the spans collected
  through set-up and window: what tracing on costs end to end;
* ``off``: the untraced run as ``benchmark/run.py`` makes it.

``--mix`` merges keys into the cell's traffic (``entry``, ``clients``,
``batcher``), ``--cfg`` into its configuration (a CPU rehearsal at a tiny
size: ``--device cpu``; the CPU's trace has no device operations, so the
device numbers come out None there).  ``--span-cost`` prints the nanoseconds of one span
opened and closed with tracing off and on, on the host it runs on.  The
benchmark itself leaves the collection off; this script is the one
place a run collects it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import benchmark.run  # noqa: E402,F401  (the build and cache places)

SPAN_COST_LOOP = 1_000_000      # spans a timed loop of --span-cost


def span_cost(n: int) -> dict:
    """ns per span opened and closed (best of 5 loops of ``n``)."""
    from rag_challenge_2_tpu_torch.utils import profiling as pf

    def loop(body) -> float:
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter_ns()
            body()
            best = min(best, (time.perf_counter_ns() - t) / n)
        return best

    def empty():
        for _ in range(n):
            pass

    def plain():
        for _ in range(n):
            with pf.span("dense.launch"):
                pass

    def with_attrs():
        for _ in range(n):
            with pf.span("dense.topk", request=pf.NEW) as sp:
                if sp is not None:
                    sp.attrs.update(queries=127, rows=10_000_000, k=30)

    def note():
        for _ in range(n):
            pf.note(regime="int8_large")

    out = {"empty_loop_ns": loop(empty)}
    out.update(off_span_ns=loop(plain), off_span_attrs_ns=loop(with_attrs),
               off_note_ns=loop(note))
    with pf.collect() as spans:
        out.update(on_span_ns=loop(plain), on_span_attrs_ns=loop(with_attrs))
        out["on_recorded"] = len(spans)
    return out


def program_numbers(res: dict, events, t0: int, t1: int, spans) -> dict:
    from benchmark import program_trace as pt_mod

    pt = pt_mod.reduce_program(events, t0, t1, spans)
    in_window = list(pt.spans.values())
    calls = pt.named("dense.topk")
    b = res["run"].batcher
    out = {
        "dense.host_gap_ms": pt_mod.host_gap_ms(pt),
        "dense.ops_per_call": pt_mod.ops_per_call(pt),
        "batcher.queue_wait_ms": pt_mod.queue_wait_ms(in_window),
        "batcher.requests_per_dispatch": (b["batched_requests"] / b["dispatches"]
                                          if b.get("dispatches") else None),
        "engine.prepare_ms": pt_mod.prepare_ms(in_window),
        "window_s": pt.window_s,
        "idle_s_by_span": dict(sorted(pt.idle_by.items(), key=lambda kv: -kv[1])),
        "idle_ms_per_dense_call_by_span": (
            {k: v * 1e3 / len(calls) for k, v in pt.idle_by.items()} if calls else None),
        "dense_calls": len(calls),
        "device_ops": pt.device_ops, "tied": pt.tied, "unlinked": pt.unlinked,
        "inside_tied_by_prefix": {p or "any": list(v) for p, v in pt.inside_by.items()},
        "spans_by_name": _count(sp.name for sp in in_window),
    }
    if calls:
        dur = [(sp.t1_ns - sp.t0_ns) / 1e6 for sp in calls]
        out["dense.topk_host_ms_median"] = statistics.median(dur)
    out["summary"] = pt_mod.summary(pt)
    return out


def _count(names) -> dict:
    out: dict = {}
    for n in names:
        out[n] = out.get(n, 0) + 1
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--mode", choices=("traced", "spans", "off"), default="traced")
    p.add_argument("--mix", default=None, help="JSON keys merged into the traffic")
    p.add_argument("--cfg", default=None, help="JSON keys merged into the configuration")
    p.add_argument("--device", default="cuda")
    p.add_argument("--span-cost", action="store_true")
    a = p.parse_args(argv)

    import torch

    from rag_challenge_2_tpu_torch.utils import profiling

    if a.span_cost:
        print(json.dumps({"span_cost": span_cost(SPAN_COST_LOOP), "host": _host()}), flush=True)
        return 0
    from benchmark import harness

    spec = harness.bench()
    cells = {w["name"]: w for w in spec["workloads"]}
    cell = cells.get(a.workload) or harness.unlisted_cell(a.workload)
    if cell is None or a.seed is None:
        print(f"unknown workload {a.workload!r} or no --seed", file=sys.stderr)
        return 2
    if a.device == "cuda" and not torch.cuda.is_available():
        print("trace_cell: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0) if a.device == "cuda" else torch.device(a.device)
    cfg = harness.load("configs", cell["config"])
    if a.cfg:
        cfg.update(json.loads(a.cfg))
    mix = harness.load("traffic", cell["traffic"])
    if a.mix:
        mix.update(json.loads(a.mix))
    limits = harness.load("limits", a.workload)
    traced = a.mode == "traced"
    metrics = spec["per_layer"] if traced else spec["end_to_end"]
    if a.workload not in cells:
        extra = cell["per_layer"] if traced else []
        metrics = [dict(m, workloads=[a.workload]) for m in metrics + extra]

    def log(*x):
        print(*x, file=sys.stderr, flush=True)

    kept: dict = {}
    base = torch.profiler.profile

    class Profile(base):
        """The harness's profiler, with the program's spans collected
        between its start and stop."""

        def start(self):
            super().start()
            kept["t0"] = time.time_ns()
            kept["col"] = profiling.collect()
            kept["col"].start()
            kept["prof"] = self

        def stop(self):
            kept["col"].stop()
            kept["t1"] = time.time_ns()
            super().stop()

    col = None
    if traced:
        torch.profiler.profile = Profile
    elif a.mode == "spans":
        col = profiling.collect()
        col.start()
    try:
        res = harness.run_cell(a.workload, cfg, mix, limits, a.seed, a.seconds, traced, dev,
                               time.perf_counter(), log)
    finally:
        torch.profiler.profile = base
        if col is not None:
            col.stop()
    line = harness.result_line(res, metrics, traced, limits, dev)
    line["mode"] = a.mode
    line["power_limit_w"] = _host().get("power_limit")
    lines = [json.dumps(line)]
    if traced:
        events = kept["prof"].profiler.kineto_results.events()
        prog = program_numbers(res, events, kept["t0"], kept["t1"], kept["col"].spans)
        log(prog.pop("summary"))
        lines.append(json.dumps({"program": prog}))
    elif col is not None:
        lines.append(json.dumps({"spans_recorded": len(col.spans),
                                 "by_name": _count(sp.name for sp in col.spans)}))
    for ln in lines:
        print(ln, flush=True)
    return 0


def _host() -> dict:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    name, _, limit = out.partition(",")
    return {"gpu": name.strip(), "power_limit": limit.strip()}


if __name__ == "__main__":
    sys.exit(main())
