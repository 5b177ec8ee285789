#!/usr/bin/env python3
"""Kernel K1's launches one by one: device time per kernel and the
wrapper's host time per call.

    python3 scripts/k1_profile.py [--rows 10240,250000] [--batches 8,64] [--dim 1024]

For each store size, dtype (bf16, f32) and batch it runs
``dense_topk_fused`` under ``torch.profiler`` and prints every device
kernel of the call (the scoring launch ``scan_float`` and the merge
``merge_lists``) with its mean device time, then the host time per call
(200 calls, no synchronise) and the wall time per call.  It takes the
package from the checkout it sits in and needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="10240,250000")
    ap.add_argument("--batches", default="8,64")
    ap.add_argument("--dim", type=int, default=1024)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("k1_profile: no CUDA card")
    from rag_challenge_2_tpu_torch.ops.dense_topk import dense_topk_fused

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def unit(n):
        x = torch.randn(n, args.dim, generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    q = unit(64)
    for N in [int(x) for x in args.rows.split(",") if x]:
        base = unit(N)
        for dt in (torch.bfloat16, torch.float32):
            emb = base.to(dt)
            for B in [int(x) for x in args.batches.split(",") if x]:
                qq = q[:B].contiguous()
                for _ in range(3):
                    dense_topk_fused(qq, emb, 30)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        dense_topk_fused(qq, emb, 30)
                    torch.cuda.synchronize()
                name = str(dt).split(".")[1]
                for ev in prof.key_averages():
                    us = (getattr(ev, "self_device_time_total", 0)
                          or getattr(ev, "self_cuda_time_total", 0))
                    if us:
                        print(f"K1 N={N} {name} B={B}: {ev.key[:48]:48s} x{ev.count}  "
                              f"{us / ev.count:.1f} us", flush=True)
                t0 = time.perf_counter()
                for _ in range(200):
                    dense_topk_fused(qq, emb, 30)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                print(f"K1 N={N} {name} B={B}: host {1e6 * (t1 - t0) / 200:.1f} us per call, "
                      f"wall {1e6 * (t2 - t0) / 200:.1f} us per call", flush=True)


if __name__ == "__main__":
    main()
