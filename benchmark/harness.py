"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, and the result line.

A cell is ``<config>.<mix>`` in ``BENCHMARK.json``; its configuration is
``configs/<config>.json``, its traffic ``traffic/<mix>.json``, the
limits of its check ``limits/<cell>.json`` and each metric is read by
``metrics/<metric>.py``.  Adding a configuration, a mix, a metric or a
cell adds files and entries; nothing here names one.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, loops, stores, system, traffic
from .roofline import DenseWork
from .trace import Spans, Trace, breakdown, reduce

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rag_challenge_2_tpu")


def load(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def reader(metric: str, attr: str = "read"):
    """``metrics/<metric>.py``'s ``read(run)`` (or another attribute)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


def unlisted_cell(name: str) -> Optional[dict]:
    """``<config>.<mix>`` with both files but no entry in ``BENCHMARK.json``
    (measured before it is added): one chip, every per-layer reader that
    no listed metric names."""
    config, _, traffic = name.partition(".")
    if not ((HERE / "configs" / f"{config}.json").exists()
            and (HERE / "traffic" / f"{traffic}.json").exists()
            and (HERE / "limits" / f"{name}.json").exists()):
        return None
    spec = bench()
    listed = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    extra = [{"name": p.stem, "unit": reader(p.stem, "UNIT")}
             for p in sorted((HERE / "metrics").glob("*.py")) if p.stem not in listed]
    return {"name": name, "config": config, "traffic": traffic, "chips": 1,
            "per_layer": extra}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is the JAX stack or the JAX
    package (whole names: the port's own name starts with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """Everything a metric reader may read."""
    cell: str
    cfg: dict
    mix: dict
    trace: bool
    setup_s: float = 0.0
    window: Optional[loops.Window] = None
    queries_per_request: int = 0
    recall: Optional[float] = None
    spans: Spans = field(default_factory=Spans)
    batcher: Dict[str, int] = field(default_factory=dict)
    traced: Optional[Trace] = None


def dense_work_of_hits(dtype: str):
    """The work of one ``engine.dense_hits(index, req, cfg, window, k)``:
    the routed slots' rows, every query once."""
    def work(index, req, cfg, window=0, k=None):
        slots = [m for m in range(len(req.doc_valid)) if req.doc_valid[m]]
        rows = sum(int(req.win_len[m]) for m in slots)
        kk = min(cfg.top_k if k is None else k, index.n_pad)
        return DenseWork(dtype, int(req.q.shape[0]), rows, int(index.dim), kk, len(slots))
    return work


class SetUp:
    """A cell's inputs and the system under test, warmed up: ``call(i)``
    sends request ``i`` of the pool (a scan batch or a question) and
    returns its host answer."""

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device):
        self.cfg, self.mix, self.dev = cfg, mix, dev
        self.store = store = stores.Store(cfg, seed, dev)
        if dev.type == "cuda":
            system.build_kernels(None)
        if mix["loop"] == "scan":
            rows = traffic.scan_rows(mix, store, seed)
            self.emb, self.scale, src = system.build_rows(store, rows)
            self.q = traffic.make_vectors(src, mix, store, seed)
            del src
            self.B, self.k = int(mix["batch"]), int(mix["k"])
            self.batches = [self.q[b * self.B:(b + 1) * self.B].contiguous()
                            for b in range(int(mix["pool_batches"]))]
            self.dense = system.dense_topk()
            self.pool = self.q
            self.n_items, self.queries_per_request = len(self.batches), self.B
        else:
            self.pool = traffic.questions(mix, store, seed)
            wanted = np.concatenate([qn.rows for qn in self.pool])
            order = np.argsort(wanted, kind="stable")
            self.emb, self.scale, src = system.build_rows(store, wanted[order])
            vec = torch.empty_like(src)
            vec[torch.as_tensor(order, device=dev)] = traffic.make_vectors(src, mix, store, seed)
            vec = vec.cpu().numpy()
            del src
            Q = int(mix["queries_per_request"])
            for i, qn in enumerate(self.pool):
                qn.vectors = vec[i * Q:(i + 1) * Q]
            self.engine = system.build_engine(store, self.emb, self.scale, store.csr())
            self.scfg = system.search_config(mix)
            self.front = (system.batcher(self.engine, mix) if mix["entry"] == "batcher"
                          else None)
            self.n_items, self.queries_per_request = len(self.pool), Q
        self.warm_up()

    def call(self, i: int):
        if self.mix["loop"] == "scan":
            v, r = self.dense(self.batches[i], self.emb, self.k, row_scale=self.scale)
            return r.cpu().numpy(), v.cpu().numpy()
        qn = self.pool[i]
        fn = self.front.search if self.front is not None else self.engine.search
        fc = fn(qn.vectors, self.cfg["company"], qn.texts[0], selected_years=qn.years,
                cfg=self.scfg, query_texts=qn.texts).to("cpu")
        return fc.key.numpy(), fc.score.numpy()

    def warm_up(self) -> None:
        """Every shape the window uses: each scan batch, or a question of
        each route (through the batcher: each route at every stack size up
        to its largest)."""
        if self.mix["loop"] == "scan":
            for b in range(self.n_items):
                self.call(b)
        else:
            routes: Dict[tuple, List[int]] = {}
            for i, qn in enumerate(self.pool):
                routes.setdefault(tuple(qn.docs), []).append(i)
            for members in routes.values():
                self.call(members[0])
                R = 2
                while self.front is not None and R <= int(self.mix["batcher"]["max_batch"]):
                    sel = [self.pool[members[j % len(members)]] for j in range(R)]
                    self.engine.search_many(
                        [s.vectors for s in sel], self.cfg["company"], sel[0].texts[0],
                        selected_years=sel[0].years, cfg=self.scfg,
                        query_texts_list=[s.texts for s in sel])
                    R *= 2
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def bracket(self, spans: Spans) -> None:
        """Set the traced run's brackets around the layers' calls."""
        if self.mix["loop"] == "scan":
            work = DenseWork(self.cfg["dtype"], self.B, self.store.n_rows, self.store.dim,
                             self.k)
            self.dense = spans.bracket("dense", self.dense, work=lambda *a, **kw: work)
            return
        eng = system.engine_module()
        spans.wrap(eng, "dense_hits", "dense", work=dense_work_of_hits(self.cfg["dtype"]))
        spans.wrap(eng, "bm25_hits", "bm25", events=self.dev.type == "cuda")
        spans.wrap(eng, "fuse_blocks", "fuse")
        spans.wrap(eng.QueryEngine, "search", "dispatch")
        spans.wrap(eng.QueryEngine, "search_many", "dispatch")

    def free(self) -> None:
        """Drop the program's state (the reference runs after it)."""
        for name in ("emb", "scale", "batches", "dense", "engine", "front"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(cell: str, cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
             trace: bool, dev: torch.device, t_start: float, log=print) -> dict:
    """Run ``cell`` once and return its result (the metrics not yet read:
    :func:`result_line` does that)."""
    run = Run(cell, cfg, mix, trace)
    su = SetUp(cfg, mix, seed, dev)
    run.queries_per_request = su.queries_per_request
    if trace:
        su.bracket(run.spans)
    front = getattr(su, "front", None)
    before = dict(front.stats) if front is not None else {}
    counters0 = system.kernel_counters()

    # ------------------------------------------------------------ window
    tspan = [0, 0]
    tsec = float(mix.get("trace_seconds") or seconds)
    profiler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        profiler = profile(activities=acts)

        def stop():
            if dev.type == "cuda":
                torch.cuda.synchronize()
            tspan[1] = time.time_ns()
            profiler.stop()

        profiler.start()        # on before the window: its start-up is not in it
        tspan[0] = time.time_ns()
    run.setup_s = time.perf_counter() - t_start
    if mix["loop"] == "scan":
        state = {"on": trace}

        def tick(elapsed):
            if state["on"] and elapsed >= tsec:
                stop()
                state["on"] = False

        win = loops.scan(su.call, su.n_items, seconds, tick if trace else None)
        if state["on"]:
            stop()
    else:
        def main(w_start):
            if trace:
                time.sleep(max(0.0, tsec - (time.perf_counter() - w_start)))
                stop()

        win = loops.served(su.call, traffic.client_orders(mix, su.n_items, seed), seconds,
                           main)
        if front is not None:
            run.batcher = {k: front.stats[k] - before.get(k, 0) for k in front.stats}
    run.window = win
    run.spans.restore()
    buckets = np.bincount([int((d.t1 - win.start) // 5) for d in win.done])
    log(f"requests completed a 5 s part of the window: {buckets.tolist()}")
    counters = {k: v - counters0.get(k, 0) for k, v in system.kernel_counters().items()}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of the JAX stack or package loaded: {found}")
    peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
    if trace:
        run.traced = reduce(profiler.profiler.kineto_results.events(), tspan[0], tspan[1],
                            run.spans, ("dense", "bm25", "fuse", "dispatch"))
        profiler = None
        t = run.traced
        log(f"trace: {t.kernels} device operations in {t.window_s:.3f} s, {t.unlinked} "
            f"without their launch; threads launching / bracketed / both {t.threads}; "
            f"{t.brackets_in_window} brackets in the window, tied to the trace {t.bracket_calls}, device s "
            f"{t.bracket_device_s}, least s {t.bracket_work_s}")

    # ------------------------------------------------ free, then check
    front = None
    su.free()
    t_check = time.perf_counter()
    numbers, run.recall = verify(su.store, mix, limits, win, su.pool)
    log(f"check took {time.perf_counter() - t_check:.1f} s; launches in the window {counters}")
    return dict(run=run, numbers=numbers, peak=peak, counters=counters)


def verify(store: stores.Store, mix: dict, limits: dict, win: loops.Window, pool):
    """The compared numbers over every distinct answer of the window, and
    the window's recall@10 against the f32 answers."""
    mode = limits["mode"]
    by_item: Dict[int, Dict[bytes, loops.Done]] = {}
    for d in win.done:
        by_item.setdefault(d.item, {})[d.a.tobytes() + d.b.tobytes()] = d
    readings = []
    if mix["loop"] == "scan":
        B, k = int(mix["batch"]), int(mix["k"])
        P = pool.shape[0]
        width = max([len(v) for v in by_item.values()], default=1) * k
        asked = np.full((P, width), -1, np.int64)
        for b, answers in by_item.items():
            for u, d in enumerate(answers.values()):
                asked[b * B:(b + 1) * B, u * k:(u + 1) * k] = d.a
        pv, pr, f32_rows, at = check.scan_reference(store, pool, mode, asked)
        for b, answers in by_item.items():
            sl = slice(b * B, (b + 1) * B)
            for u, d in enumerate(answers.values()):
                readings.append(check.compare_scan(d.a, d.b, at[sl, u * k:(u + 1) * k],
                                                   pv[sl], pr[sl], k, store.n_rows))
        hits = [check.recall(d.a, f32_rows[d.item * B:(d.item + 1) * B]) for d in win.done]
    else:
        top_n = mix["search"]["top_n"]
        ref = check.served_reference(store, pool, mix, mode, limits["ties"])
        for i, answers in by_item.items():
            for d in answers.values():
                readings.append(check.compare_served(d.a, d.b, ref[i], top_n))
        hits = [float(np.isin(ref[d.item][3][:10], d.a[:10]).sum()) / 10 for d in win.done]
    numbers = check.worst(readings)
    for name in limits["limits"]:
        numbers.setdefault(name, 0.0)
    return numbers, (float(np.mean(hits)) if hits else None)


def result_line(res: dict, metrics: List[dict], trace: bool, limits: dict,
                dev: torch.device) -> dict:
    run: Run = res["run"]
    win = run.window
    out_metrics = {}
    for m in metrics:
        if "workloads" in m and run.cell not in m["workloads"]:
            continue
        value = reader(m["name"])(run)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(res["peak"])}
    line = {"correct": None, "attempted": len(win.done) + len(win.failed),
            "failed": len(win.failed), "metrics": out_metrics, "device": device}
    if trace and run.traced is not None:
        device["busy_s"] = run.traced.busy_s
        device["window_s"] = run.traced.window_s
        line["breakdown"] = breakdown(run.traced)
    checks = {name: {"value": res["numbers"].get(name, 0.0), "limit": lim}
              for name, lim in limits["limits"].items()}
    line["correct"] = bool(win.done) and not win.failed and all(
        c["value"] <= c["limit"] for c in checks.values())
    line["checks"] = checks
    return line
