#!/usr/bin/env python3
"""The encoder quality eval's default recipe over seeds and teachers.

    python3 scripts/encoder_quality_seeds.py [--seeds 0 1 2] [--device-teacher-seed 0]
        [--ict-steps 5000] [--ablation-steps 0] [--supervised-steps 0] [--device cuda]

Runs ``eval/encoder_quality.run_quality_eval`` once per seed with the
host BM25 teacher (the port's default), then once with
``host_teacher=False`` (positives mined by ``bm25_scores`` on the device,
as the JAX package's recorded runs mined them).  The default recipe
(``encoder_alias_distill``) trains ``--ict-steps`` steps; the ablation
arms and the supervised stage are cut to ``--ablation-steps`` /
``--supervised-steps`` (0: not trained), since only the default recipe is
compared.  Each run is a process of its own, all started together (the
host sampler sets a run's pace, one core each).  Prints the card's name
and power limit, each run's hit@10 / MRR beside the JAX package's records
in ``docs/ENCODER_QUALITY.json``, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
ARM = "encoder_alias_distill"


def one_run(args) -> dict:
    from rag_challenge_2_tpu_torch.eval.encoder_quality import run_quality_eval

    t0 = time.perf_counter()
    res = run_quality_eval(ict_steps=args.ict_steps, supervised_steps=args.supervised_steps,
                           seed=args.seed, device=args.device,
                           ablation_steps=args.ablation_steps,
                           host_teacher=not args.device_teacher,
                           log=lambda *a: print(*a, file=sys.stderr, flush=True))
    return dict(seed=args.seed, teacher="device" if args.device_teacher else "host",
                seconds=time.perf_counter() - t0, results=res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--device-teacher-seed", type=int, default=0)
    ap.add_argument("--ict-steps", type=int, default=5000)
    ap.add_argument("--ablation-steps", type=int, default=0)
    ap.add_argument("--supervised-steps", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--device-teacher", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_run(args)), flush=True)
        return 0

    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        from rag_challenge_2_tpu_torch.utils.kernels import build_all

        build_all()                 # once, before the runs load the libraries
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    jobs = [(s, False) for s in args.seeds] + [(args.device_teacher_seed, True)]
    common = ["--ict-steps", str(args.ict_steps), "--ablation-steps",
              str(args.ablation_steps), "--supervised-steps", str(args.supervised_steps),
              "--device", args.device]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--one", "--seed", str(s), *common]
        + (["--device-teacher"] if dev_teacher else []),
        stdout=subprocess.PIPE, text=True) for s, dev_teacher in jobs]
    runs = []
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            print(f"a run failed with code {p.returncode}", file=sys.stderr)
            return 1
        runs.append(json.loads(out.strip().splitlines()[-1]))
    record = json.loads((ROOT / "docs" / "ENCODER_QUALITY.json").read_text())
    ref = {0: record[ARM], 1: record[f"{ARM}_seed1"]}
    rows = []
    for r in runs:
        got = r["results"][ARM]
        want = ref.get(r["seed"])
        rows.append(dict(seed=r["seed"], teacher=r["teacher"], seconds=r["seconds"],
                         hit10=got["hit@10"], mrr=got["mrr"],
                         bm25=r["results"]["bm25"], random_init=r["results"][
                             "encoder_random_init"],
                         jax_hit10=None if want is None else want["hit@10"],
                         jax_mrr=None if want is None else want["mrr"]))
        print(f"seed {r['seed']}, {r['teacher']} teacher, {args.ict_steps} steps: "
              f"{ARM} hit@10 {got['hit@10']:.3f} MRR {got['mrr']:.4f}"
              + ("" if want is None else
                 f" (JAX record, device teacher: {want['hit@10']:.2f} / {want['mrr']:.4f})")
              + f"; {r['seconds']:.1f} s", flush=True)
    print(json.dumps({"arm": ARM, "ict_steps": args.ict_steps, "runs": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
