#!/usr/bin/env python3
"""Kernels K1 and K3 (f32 / bf16 forms) by batch, beside their bounds.

    python3 scripts/float_scan_sweep.py [--k1-rows 250000,10240] [--k3-rows 1000000]
                                        [--k1-batches 1,4,8,16,32,64]
                                        [--k3-batches 8,64,65,127,128]
                                        [--dim 1024] [--seed 0]

Times ``dense_topk_fused`` (K1, B = 1 .. 64) and ``stream_topk`` (K3,
B = 8 .. 128) on random unit rows, k = 30, f32 and bf16 stores: the median
of 15 CUDA-event timings with the L2 cache flushed and the device parked
behind a spin before each.  Beside each time: the planner's tile, the
bound (the store read over 3.35 TB/s or the FMAs over 67 TFLOP/s, the
larger) and ``torch.matmul`` (TF32 off) + ``torch.topk``.  Prints one JSON
line at the end.  It takes the package from the checkout it sits in (an
older checkout works once ``utils/timing.py`` is copied into it: the
planner's columns are then left out) and needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
K1_BATCHES = (1, 4, 8, 16, 32, 64)
K3_BATCHES = (8, 64, 65, 127, 128)


def bound_ms(B, N, D, elt, k):
    nbytes = N * D * elt + B * D * 4 + 8 * B * k
    return max(nbytes / HBM_BYTES_S, 2 * B * N * D / F32_OPS_S) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1-rows", default="250000,10240")
    ap.add_argument("--k3-rows", default="1000000")
    ap.add_argument("--k1-batches", default=",".join(map(str, K1_BATCHES)))
    ap.add_argument("--k3-batches", default=",".join(map(str, K3_BATCHES)))
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("float_scan_sweep: no CUDA card")
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk
    from rag_challenge_2_tpu_torch.utils.timing import cuda_ms

    # the module, not the function of that name the package exports
    k1 = importlib.import_module("rag_challenge_2_tpu_torch.ops.dense_topk")
    try:
        from rag_challenge_2_tpu_torch.ops import float_scan as fs
    except ImportError:                     # a checkout from before the planner
        fs = None

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    D, k = args.dim, 30
    sms = fs.sm_count(dev) if fs else 0
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    q_all = torch.randn(128, D, generator=gen, device=dev)
    q_all = q_all / q_all.norm(dim=1, keepdim=True)
    out = {}

    def unit(n):
        x = torch.randn(n, D, generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    def library(q, emb):
        return cuda_ms(lambda: torch.topk(torch.matmul(q.to(emb.dtype), emb.T).float(), k,
                                          dim=1), flush, reps=7)

    for N in [int(x) for x in args.k1_rows.split(",") if x]:
        base = unit(N)
        for dt in (torch.bfloat16, torch.float32):
            emb = base.to(dt)
            name = str(dt).split(".")[1]
            for B in [int(x) for x in args.k1_batches.split(",") if x]:
                q = q_all[:B].contiguous()
                ms = cuda_ms(lambda: k1.dense_topk_fused(q, emb, k), flush, reps=15)
                lib = library(q, emb)
                bnd = bound_ms(B, N, D, emb.element_size(), k)
                row = dict(ms=ms, bound_ms=bnd, library_ms=lib)
                if fs:
                    pl = k1.plan(B, N, k, dt == torch.bfloat16, sms)
                    row.update(tile=pl.query_tile, chunks=pl.n_chunks, box_rows=pl.box_rows,
                               stages=pl.stages)
                out[f"K1 {name} N={N} B={B}"] = row
                print(f"K1 {name} N={N} B={B}: " + "  ".join(
                    f"{a} {b:.4f}" if isinstance(b, float) else f"{a} {b}"
                    for a, b in row.items()), flush=True)
    for N in [int(x) for x in args.k3_rows.split(",") if x]:
        base = unit(N)
        for dt in (torch.float32, torch.bfloat16):
            emb = base.to(dt)
            name = str(dt).split(".")[1]
            for B in [int(x) for x in args.k3_batches.split(",") if x]:
                q = q_all[:B].contiguous()
                ms = cuda_ms(lambda: stream_topk(q, emb, k), flush, reps=7)
                lib = library(q, emb)
                bnd = bound_ms(B, N, D, emb.element_size(), k)
                out[f"K3 {name} N={N} B={B}"] = dict(ms=ms, bound_ms=bnd, library_ms=lib)
                print(f"K3 {name} N={N} B={B}: {ms:.4f} ms  bound {bnd:.4f}  "
                      f"matmul + topk {lib:.4f}", flush=True)
            del emb
        del base
    print(json.dumps(out))


if __name__ == "__main__":
    main()
