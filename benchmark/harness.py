"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, and the result line.

A cell is ``<config>.<mix>`` in ``BENCHMARK.json``; its configuration is
``configs/<config>.json``, its traffic ``traffic/<mix>.json``, the
limits of its check ``limits/<cell>.json`` and each metric is read by
``metrics/<metric>.py``.  Adding a configuration, a mix, a metric or a
cell adds files and entries; nothing here names one.  A configuration
with a ``model`` section runs its model through the port's embedding
entry (the ``encode`` loop); its reference model is the file its
``model.reference`` names under ``reference/models/``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, loops, stores, system, traffic
from .program_trace import ProgramTrace, reduce_program, summary
from .roofline import DenseWork, ModelWork, peak_key
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
    """Everything a metric reader may read: the window's requests, the
    benchmark's brackets (``spans``, named by ``brackets`` in the order an
    idle gap is put down to them) and their reduced trace (``traced``),
    the port's launch counters over the window (``counters``), and with a
    mix's ``program_spans`` the port's own span records of the traced
    window (``program_spans``) laid over its trace (``program_trace``)."""
    cell: str
    cfg: dict
    mix: dict
    trace: bool
    setup_s: float = 0.0
    window: Optional[loops.Window] = None
    queries_per_request: int = 0
    recall: Optional[float] = None
    spans: Spans = field(default_factory=Spans)
    brackets: Tuple[str, ...] = ()
    batcher: Dict[str, int] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    traced: Optional[Trace] = None
    program_spans: Optional[list] = None
    program_trace: Optional[ProgramTrace] = None


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
    sends request ``i`` of the pool (a scan batch, a question or an id
    batch) and returns its host answer."""

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.reference_s = 0.0      # the reference's seconds inside set-up
        self.store = store = stores.Store(cfg, seed, dev)
        if dev.type == "cuda":
            system.build_kernels(None)
        loop = mix["loop"]
        if loop == "scan":
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
        elif loop == "encode":
            self.set_up_encode()
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

    # ------------------------------------------------------------ encode
    def set_up_encode(self) -> None:
        """The model from the benchmark's weights, the pool of id batches,
        and with ``then`` the store, with ``planted`` rows near each pool
        text's reference embedding.  The planting runs the reference: its
        seconds are ``reference_s``, which ``setup_s`` leaves out, and the
        memory peak is read from after it."""
        mix, model = self.mix, self.cfg["model"]
        self.ref = check.model_reference(model)
        self.ids = traffic.token_batches(mix, self.seed, *self.ref.token_space(model))
        self.B = int(mix["batch"])
        self.pool, self.n_items, self.queries_per_request = self.ids, len(self.ids), self.B
        self.then = mix.get("then")
        self.ref_emb: Optional[List[np.ndarray]] = None
        state = self.weights()
        if self.then:
            if self.then["entry"] != "dense_topk":
                raise ValueError(f"no encode entry {self.then['entry']!r}")
            t0 = time.perf_counter()
            self.ref_emb = self.reference_embeddings(state=state)
            self.plant(self.ref_emb)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(self.dev)
            self.reference_s = time.perf_counter() - t0
        self.model = system.embedding_model(model, state, self.dev)
        del state                   # the program keeps its own copy
        if self.then:
            self.emb, self.scale, _ = system.build_rows(self.store, np.zeros(0, np.int64))
            self.dense = system.dense_topk()
            self.k = int(self.then["k"])

    def weights(self) -> Dict[str, torch.Tensor]:
        """The model's f32 weights, drawn on the device from the seed (the
        same on every call)."""
        return self.ref.init(self.cfg["model"], stores.generator(self.dev, self.seed, "weights"),
                             self.dev)

    def reference_embeddings(self, cast=None, state=None) -> List[np.ndarray]:
        """The reference model's embeddings of every pool batch (host f32),
        with the weights ``state`` (drawn again where not given)."""
        state = self.weights() if state is None else state
        return [self.ref.forward(state, self.cfg["model"], ids, cast).cpu().numpy()
                for ids in self.ids]

    def plant(self, ref_emb: List[np.ndarray]) -> None:
        """``planted`` store rows for each pool text: its reference
        embedding plus ``planted_noise / sqrt(D)`` Gaussian noise,
        normalised, at rows drawn from the seed."""
        n = int(self.cfg["planted"])
        e = torch.as_tensor(np.concatenate(ref_emb), device=self.dev).repeat_interleave(n, 0)
        g = stores.generator(self.dev, self.seed, "planted")
        x = e + (float(self.cfg["planted_noise"]) / e.shape[1] ** 0.5) * torch.randn(
            e.shape, generator=g, device=self.dev)
        rows = stores.host_rng(self.seed, "planted").choice(self.store.n_rows, e.shape[0],
                                                            replace=False)
        order = np.argsort(rows)
        self.store.planted = (torch.as_tensor(rows[order], device=self.dev),
                              (x / x.norm(dim=1, keepdim=True))[torch.as_tensor(order,
                                                                                device=self.dev)])

    def call(self, i: int):
        loop = self.mix["loop"]
        if loop == "scan":
            v, r = self.dense(self.batches[i], self.emb, self.k, row_scale=self.scale)
            return r.cpu().numpy(), v.cpu().numpy()
        if loop == "encode":
            e = self.model.embed_tokens(self.ids[i])
            if not self.then:
                return np.empty((self.B, 0), np.int64), np.empty((self.B, 0), np.float32), \
                    e.cpu().numpy()
            v, r = self.dense(e, self.emb, self.k, row_scale=self.scale)
            return r.cpu().numpy(), v.cpu().numpy(), e.cpu().numpy()
        qn = self.pool[i]
        fn = self.front.search if self.front is not None else self.engine.search
        fc = fn(qn.vectors, self.cfg["company"], qn.texts[0], selected_years=qn.years,
                cfg=self.scfg, query_texts=qn.texts).to("cpu")
        return fc.key.numpy(), fc.score.numpy()

    def warm_up(self) -> None:
        """Every shape the window uses: each scan or id batch, or a
        question of each route (through the batcher: each route at every
        stack size up to its largest)."""
        if self.mix["loop"] != "clients":
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

    def bracket(self, spans: Spans) -> Tuple[str, ...]:
        """Set the traced run's brackets around the layers' calls; their
        names, in the order an idle gap is put down to them."""
        loop = self.mix["loop"]
        if loop == "encode":
            model = self.cfg["model"]
            dtype = peak_key(self.ref.compute_type(model))
            works = {id(t): ModelWork(self.ref.flops(model, t), self.ref.bytes(model, t), dtype)
                     for t in self.ids}
            self.model.embed_tokens = spans.bracket("encoder", self.model.embed_tokens,
                                                    work=lambda ids: works[id(ids)])
            if not self.then:
                return ("encoder",)
        if loop != "clients":
            work = DenseWork(self.cfg["dtype"], self.B, self.store.n_rows, self.store.dim,
                             self.k)
            self.dense = spans.bracket("dense", self.dense, work=lambda *a, **kw: work)
            return ("encoder", "dense") if loop == "encode" else ("dense",)
        eng = system.engine_module()
        spans.wrap(eng, "dense_hits", "dense", work=dense_work_of_hits(self.cfg["dtype"]))
        spans.wrap(eng, "bm25_hits", "bm25", events=self.dev.type == "cuda")
        spans.wrap(eng, "fuse_blocks", "fuse")
        spans.wrap(eng.QueryEngine, "search", "dispatch")
        spans.wrap(eng.QueryEngine, "search_many", "dispatch")
        return ("dense", "bm25", "fuse", "dispatch")

    def free(self) -> None:
        """Drop the program's state (the reference runs after it)."""
        for name in ("emb", "scale", "batches", "dense", "engine", "front", "model"):
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
        run.brackets = su.bracket(run.spans)
    front = getattr(su, "front", None)
    before = dict(front.stats) if front is not None else {}
    counters0 = system.kernel_counters()

    # ------------------------------------------------------------ window
    tspan = [0, 0]
    tsec = float(mix.get("trace_seconds") or seconds)
    profiler = collection = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        profiler = profile(activities=acts)
        if mix.get("program_spans"):
            collection = system.span_collection()

        def stop():
            if dev.type == "cuda":
                torch.cuda.synchronize()
            tspan[1] = time.time_ns()
            if collection is not None:
                collection.stop()
            profiler.stop()

        profiler.start()        # on before the window: its start-up is not in it
        if collection is not None:
            collection.start()
        tspan[0] = time.time_ns()
    run.setup_s = time.perf_counter() - t_start - su.reference_s
    if mix["loop"] != "clients":
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
    if su.reference_s:
        log(f"the reference in set-up took {su.reference_s:.3f} s, left out of setup_s")
    counters = {k: v - counters0.get(k, 0) for k, v in system.kernel_counters().items()}
    run.counters = counters
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of the JAX stack or package loaded: {found}")
    peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
    if trace:
        events = profiler.profiler.kineto_results.events()
        run.traced = reduce(events, tspan[0], tspan[1], run.spans, run.brackets)
        t = run.traced
        log(f"trace: {t.kernels} device operations in {t.window_s:.3f} s, {t.unlinked} "
            f"without their launch; threads launching / bracketed / both {t.threads}; "
            f"{t.brackets_in_window} brackets in the window, tied to the trace {t.bracket_calls}, device s "
            f"{t.bracket_device_s}, least s {t.bracket_work_s}, operations {t.bracket_flops}")
        if collection is not None:
            run.program_spans = list(collection.spans)
            run.program_trace = reduce_program(events, tspan[0], tspan[1], run.program_spans)
            log(f"{len(run.program_spans)} span records of the program; "
                f"{summary(run.program_trace)}")
        profiler = events = None

    # ------------------------------------------------ free, then check
    front = None
    su.free()
    t_check = time.perf_counter()
    numbers, run.recall = verify(su, limits, win)
    log(f"check took {time.perf_counter() - t_check:.1f} s; launches in the window {counters}")
    return dict(run=run, numbers=numbers, peak=peak, counters=counters)


def distinct_answers(win: loops.Window) -> Dict[int, List[loops.Done]]:
    """Each pool item's distinct answers in the window."""
    by_item: Dict[int, Dict[bytes, loops.Done]] = {}
    for d in win.done:
        key = b"".join(x.tobytes() for x in (d.a, d.b, d.c) if x is not None)
        by_item.setdefault(d.item, {})[key] = d
    return {i: list(v.values()) for i, v in by_item.items()}


def verify(su: SetUp, limits: dict, win: loops.Window):
    """The compared numbers over every distinct answer of the window, and
    the window's recall@10 against the f32 answers (``su``: the cell's
    set-up, its program state freed)."""
    store, mix, pool = su.store, su.mix, su.pool
    mode = limits["mode"]
    by_item = distinct_answers(win)
    readings = []
    hits = []
    if mix["loop"] == "scan":
        B, k = int(mix["batch"]), int(mix["k"])
        P = pool.shape[0]
        width = max([len(v) for v in by_item.values()], default=1) * k
        asked = np.full((P, width), -1, np.int64)
        for b, answers in by_item.items():
            for u, d in enumerate(answers):
                asked[b * B:(b + 1) * B, u * k:(u + 1) * k] = d.a
        pv, pr, f32_rows, at = check.scan_reference(store, pool, mode, asked)
        for b, answers in by_item.items():
            sl = slice(b * B, (b + 1) * B)
            for u, d in enumerate(answers):
                readings.append(check.compare_scan(d.a, d.b, at[sl, u * k:(u + 1) * k],
                                                   pv[sl], pr[sl], k, store.n_rows))
        hits = [check.recall(d.a, f32_rows[d.item * B:(d.item + 1) * B]) for d in win.done]
    elif mix["loop"] == "encode":
        ref = su.ref_emb if su.ref_emb is not None else su.reference_embeddings()
        for b, answers in by_item.items():
            for d in answers:
                readings.append(check.compare_embeddings(d.c, ref[b]))
        if su.then:
            # the scan's check with each answer's own embeddings as the
            # queries; recall against the reference's embeddings in f32
            B, k = su.B, su.k
            flat = [d for answers in by_item.values() for d in answers
                    if d.c.shape == ref[d.item].shape]
            q = torch.as_tensor(np.concatenate([d.c for d in flat]) if flat else
                                np.zeros((0, store.dim), np.float32), device=store.dev)
            asked = np.concatenate([d.a for d in flat]) if flat else np.zeros((0, k), np.int64)
            pv, pr, f32_rows, at = check.scan_reference(
                store, q, mode, asked, recall_q=torch.as_tensor(np.concatenate(ref),
                                                                device=store.dev))
            for u, d in enumerate(flat):
                sl = slice(u * B, (u + 1) * B)
                readings.append(check.compare_scan(d.a, d.b, at[sl], pv[sl], pr[sl], k,
                                                   store.n_rows))
            hits = [check.recall(d.a, f32_rows[d.item * B:(d.item + 1) * B]) for d in win.done]
    else:
        top_n = mix["search"]["top_n"]
        ref = check.served_reference(store, pool, mix, mode, limits["ties"])
        for i, answers in by_item.items():
            for d in answers:
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
