"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <config>.<mix> --seed N --seconds S --trace 0|1

It makes the cell's inputs from the seed, builds the system under test
(the ``rag_challenge_2_tpu_torch`` port) on the card, warms it up,
measures one window of ``S`` seconds, checks the window's answers against
the plain reference and prints one JSON line last on standard output:
the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), each compared number beside its limit last of all.  A
``<config>.<mix>`` that ``BENCHMARK.json`` does not list yet runs too,
with every metric that has a reader.  It exits non-zero, printing no
result, without a CUDA card (it never falls back to the CPU), or when the
JAX stack or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's build and kernel caches, at fixed places in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "nv")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.bench()
    cells = {w["name"]: w for w in spec["workloads"]}
    cell = cells.get(a.workload) or harness.unlisted_cell(a.workload)
    if cell is None:
        print(f"unknown workload {a.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"no CUDA card for {a.workload} (it needs {cell['chips']}): "
              "this benchmark measures the card only", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cfg = harness.load("configs", cell["config"])
    mix = harness.load("traffic", cell["traffic"])
    limits = harness.load("limits", a.workload)
    metrics = spec["per_layer"] if a.trace else spec["end_to_end"]
    if a.workload not in cells:         # a cell measured before it is listed
        extra = cell["per_layer"] if a.trace else []
        metrics = [dict(m, workloads=[a.workload]) for m in metrics + extra]

    def log(*x):
        print(*x, file=sys.stderr, flush=True)

    res = harness.run_cell(a.workload, cfg, mix, limits, a.seed, a.seconds, bool(a.trace),
                           dev, T_START, log)
    line = harness.result_line(res, metrics, bool(a.trace), limits, dev)
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
