"""The control of a cell's check: an answer one precision below the
configuration's, which the check has to call not correct.

* int8 store: the plain reference in the program's place with its rows
  coded to int4 (``reference/scoring.py``, mode ``int4``).
* bf16 store: the program's own int8 path switched on: its store coded
  by ``ops.quant.quantize_rows`` and served by the same entry.

For each seed it sets the cell up as a run does, takes the program's
answer and the control's to every request of the pool, and prints the
compared numbers of both beside the limits, one JSON line a seed:

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, harness, loops, system  # noqa: E402
from benchmark.reference import fusion, scoring  # noqa: E402


def answers(su: "harness.SetUp") -> loops.Window:
    """The program's answer to every request of the pool, once each."""
    w = loops.Window()
    for i in range(su.n_items):
        a, b = su.call(i)
        w.done.append(loops.Done(i, 0.0, 0.0, a, b))
    return w


def control_answers(su: "harness.SetUp", limits: dict) -> loops.Window:
    """The control's answer to every request of the pool."""
    w = loops.Window()
    int8 = limits["mode"] == "int8"
    if su.mix["loop"] == "scan":
        if int8:
            top = scoring.TopPool(su.q.shape[0], su.k, su.dev)
            for s, _, x in su.store.each_chunk():
                top.add(scoring.scores(su.q, x, "int4"), s)
            for b in range(su.n_items):
                sl = slice(b * su.B, (b + 1) * su.B)
                w.done.append(loops.Done(b, 0.0, 0.0, top.rows[sl].cpu().numpy(),
                                         top.vals[sl].float().cpu().numpy()))
        else:
            codes, scale = system.int8_store(su.emb)
            for b in range(su.n_items):
                v, r = su.dense(su.batches[b], codes, su.k, row_scale=scale)
                w.done.append(loops.Done(b, 0.0, 0.0, r.cpu().numpy(), v.cpu().numpy()))
        return w
    top_n = su.mix["search"]["top_n"]
    if int8:
        ref = check.served_reference(su.store, su.pool, su.mix, "int4",
                                     {"dense": 0.0, "bm25": 0.0})
        for i, (keys, _, hi, _) in enumerate(ref):
            kk = fusion.top_keys(keys, hi, top_n)
            sc = hi[np.searchsorted(keys, kk)]
            w.done.append(loops.Done(i, 0.0, 0.0, kk, sc.astype(np.float32)))
        return w
    codes, scale = system.int8_store(su.emb)
    index = su.engine.index
    index.emb, index.emb_scale = codes, scale
    su.emb = codes
    for i in range(su.n_items):
        a, b = su.call(i)
        w.done.append(loops.Done(i, 0.0, 0.0, a, b))
    return w


def readings(cell: str, seed: int, dev: torch.device, cfg=None, mix=None, limits=None):
    """``(program's numbers, control's numbers)`` for one seed."""
    config, traffic = cell.split(".")
    cfg = cfg or harness.load("configs", config)
    mix = mix or harness.load("traffic", traffic)
    limits = limits or harness.load("limits", cell)
    su = harness.SetUp(cfg, mix, seed, dev)
    prog = answers(su)
    ctrl = control_answers(su, limits)
    su.free()
    got = harness.verify(su.store, mix, limits, prog, su.pool)[0]
    bad = harness.verify(su.store, mix, limits, ctrl, su.pool)[0]
    return got, bad


def main() -> int:
    p = argparse.ArgumentParser(description="the control of a cell's check")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    limits = harness.load("limits", a.workload)
    for seed in [int(s) for s in a.seeds.split(",")]:
        t0 = time.perf_counter()
        got, bad = readings(a.workload, seed, dev)
        print(json.dumps({"cell": a.workload, "seed": seed, "program": got, "control": bad,
                          "limits": limits["limits"],
                          "control_fails": any(bad[n] > lim for n, lim in limits["limits"].items()),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
