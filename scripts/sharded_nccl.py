#!/usr/bin/env python3
"""The sharded 10M int8 scan over an NCCL world, one card a rank.

    python3 scripts/sharded_nccl.py [--world 4] [--rows 10000000] [--reps 20]

Each rank makes its block of an int8 store of ``--rows`` x 1024 unit rows
on its own card (centre + noise rows, as chip_smoke's 10M store, from a
generator seeded per block), and rank 0 also makes the whole store on its
card from the same blocks; the 127 queries are seeded alike on every rank.
Rank 0 times the single-device scan of the whole store (``dense_topk``:
K3), then every rank scans its block and the candidates merge over NCCL,
flat over ``world`` ranks and two-level over 2 x ``world / 2``; both must
equal the single-device result bitwise on every rank.  Times are
wall-clock ms a call between barriers, the cards synchronised, after one
warm-up call.  Prints the cards' name and power limit, then one JSON line.
Needs ``world`` cards.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

D, NQ, K, CHUNK, CENTRES = 1024, 127, 30, 500_000, 4096


def _block(dev, seed, b, rows, centres):
    """Block ``b`` (``rows`` rows) as int8 codes and row scales."""
    import torch

    from rag_challenge_2_tpu_torch.ops.quant import quantize_rows

    gen = torch.Generator(device=dev).manual_seed(seed * 1000 + b + 1)
    codes = torch.empty((rows, D), dtype=torch.int8, device=dev)
    scales = torch.empty(rows, device=dev)
    for s in range(0, rows, CHUNK):
        n = min(CHUNK, rows - s)
        a = torch.randint(0, CENTRES, (n,), generator=gen, device=dev)
        e = centres[a] + (0.35 / D ** 0.5) * torch.randn(n, D, generator=gen, device=dev)
        codes[s:s + n], scales[s:s + n] = quantize_rows(e / e.norm(dim=1, keepdim=True))
    return codes, scales


def _ms(fn, reps):
    import torch
    import torch.distributed as dist

    out = fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    dist.barrier()
    return out, (time.perf_counter() - t0) / reps * 1e3


def rank(dev, seed, n_rows, reps):
    import torch
    import torch.distributed as dist

    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk
    from rag_challenge_2_tpu_torch.ops.topk import dense_topk
    from rag_challenge_2_tpu_torch.parallel import (
        make_hierarchical_topk, make_mesh, make_sharded_topk)

    world, r = dist.get_world_size(), dist.get_rank()
    per = n_rows // world
    gen = torch.Generator(device=dev).manual_seed(seed)
    centres = torch.randn(CENTRES, D, generator=gen, device=dev)
    centres /= centres.norm(dim=1, keepdim=True)
    q = torch.randn(NQ, D, generator=gen, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    codes, scales = _block(dev, seed, r, per, centres)
    single_ms = None
    ref_v = torch.empty((NQ, K), device=dev)
    ref_i = torch.empty((NQ, K), dtype=torch.int32, device=dev)
    if r == 0:
        full = [_block(dev, seed, b, per, centres) for b in range(world)]
        all_codes = torch.cat([c for c, _ in full])
        all_scales = torch.cat([s for _, s in full])
        del full
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps + 1):
            v, i = dense_topk(q, all_codes, K, row_scale=all_scales)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) / (reps + 1) * 1e3
        ref_v.copy_(v)
        ref_i.copy_(i)
        del all_codes, all_scales
    dist.broadcast(ref_v, 0)
    dist.broadcast(ref_i, 0)
    flat = make_mesh({"data": world}, "nccl", "cuda")
    two = make_mesh({"slice": 2, "device": world // 2}, "nccl", "cuda")
    out = dict(world=world, rows=n_rows, rows_a_rank=per, single_ms=single_ms)
    for name, fn in (("flat", make_sharded_topk(flat, K, "data", int8=True)),
                     ("two_level", make_hierarchical_topk(two, K, int8=True))):
        stream_topk.launches = 0
        (v, i), ms = _ms(lambda: fn(q, codes, None, scales), reps)
        same = bool(torch.equal(v, ref_v) and torch.equal(i.to(ref_i.dtype), ref_i))
        every = [None] * world
        dist.all_gather_object(every, dict(dev=str(dev), same=same,
                                           k3=stream_topk.launches))
        out[name] = dict(ms=ms, ranks=every)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from rag_challenge_2_tpu_torch.parallel import run_ranks
    from rag_challenge_2_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        print("no CUDA device: this script needs the cards", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    kernels.build_all()
    out = run_ranks(rank, args.world, "nccl", "cuda",
                    (args.seed, args.rows, args.reps), timeout=900)
    ok = all(e["same"] for part in ("flat", "two_level") for e in out[part]["ranks"])
    out["equal_to_single_device"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
