"""The control of a cell's check: an answer one precision below the
configuration's, which the check has to call not correct.

* int8 store: the plain reference in the program's place with its rows
  coded to int4 (``reference/scoring.py``, mode ``int4``).
* bf16 store: the program's own int8 path switched on: its store coded
  by ``ops.quant.quantize_rows`` and served by the same entry.
* a model (``encode`` loop): the reference model in the program's place
  with both inputs of every matrix product rounded through
  ``float8_e4m3fn`` (one scale a tensor, its largest magnitude at 448),
  for a model that computes in bf16; with ``then`` its embeddings go on
  to the store's control above.

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
        w.done.append(loops.Done(i, 0.0, 0.0, *su.call(i)))
    return w


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through ``float8_e4m3fn`` under one scale that maps its
    largest magnitude to the type's largest, 448; back in f32."""
    s = t.abs().amax().float().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def scan_control(su: "harness.SetUp", batches, int8: bool):
    """The scan's control for query ``batches``: ``(rows, values)`` host
    arrays of each, from int4 rows in the reference (an int8 store) or
    from the program's entry over its own int8 codes (a bf16 store)."""
    if int8:
        q = torch.cat(batches)
        top = scoring.TopPool(q.shape[0], su.k, su.dev)
        for s, _, x in su.store.each_chunk():
            top.add(scoring.scores(q, x, "int4"), s)
        return [(top.rows[b * su.B:(b + 1) * su.B].cpu().numpy(),
                 top.vals[b * su.B:(b + 1) * su.B].float().cpu().numpy())
                for b in range(len(batches))]
    codes, scale = system.int8_store(su.emb)
    out = []
    for q in batches:
        v, r = su.dense(q, codes, su.k, row_scale=scale)
        out.append((r.cpu().numpy(), v.cpu().numpy()))
    return out


def control_answers(su: "harness.SetUp", limits: dict) -> loops.Window:
    """The control's answer to every request of the pool (a model with
    ``then``: the model's control, then the scan's on its embeddings)."""
    w = loops.Window()
    int8 = limits["mode"] == "int8"
    if su.mix["loop"] == "encode":
        emb = su.reference_embeddings(cast=fp8_e4m3)
        none = (np.empty((su.B, 0), np.int64), np.empty((su.B, 0), np.float32))
        found = (scan_control(su, [torch.as_tensor(e, device=su.dev) for e in emb], int8)
                 if su.then else [none] * len(emb))
        for b, (e, (rows, vals)) in enumerate(zip(emb, found)):
            w.done.append(loops.Done(b, 0.0, 0.0, rows, vals, e))
        return w
    if su.mix["loop"] == "scan":
        for b, (rows, vals) in enumerate(scan_control(su, su.batches, int8)):
            w.done.append(loops.Done(b, 0.0, 0.0, rows, vals))
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
    got = harness.verify(su, limits, prog)[0]
    bad = harness.verify(su, limits, ctrl)[0]
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
