#!/usr/bin/env python3
"""Kernel K3 on a bf16 store by batch, beside its bound and yardsticks.

    python3 scripts/k3_bf16_sweep.py [--rows 1500000] [--dim 1024]
                                     [--batches 8,16,17,32,64,96,127,128]
                                     [--plain] [--seed 0]

Times ``stream_topk`` (f32 queries, k = 30) on Gaussian unit rows in bf16:
the median of 11 CUDA-event timings with the L2 cache flushed and the
device parked behind a spin before each.  Beside each time: the regime
the planner picked, the bound (the store read over 3.35 TB/s or the
products, the larger: above 16 queries the three query planes' over the
tensor cores' 989 TFLOP/s, at up to 16 the f32 products over the 67
TFLOP/s outside them, as ``scan_float`` forms them), at up to 16 queries
the time of bf16_tc on the batch with its first query repeated up to 17
(the regime's smallest batch, the same 32-query tile), ``torch.matmul`` on
bf16-rounded queries + ``torch.topk`` (the library's tensor-core product:
not the same arithmetic), with ``--plain`` the plain version, and the
largest distance of a returned value from the f64 score of its row.
Prints one JSON line at the end.  It takes the package from the checkout
it sits in (an older checkout works once ``utils/timing.py`` is there:
the regime column is then left out), so parent and change can be timed
in one chip call, and it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12
PLANES = 3
TC_MIN_QUERIES = 17


def bound_ms(B, N, D, k):
    nbytes = N * D * 2 + B * D * 4 + 8 * B * k
    ops = (PLANES * 2 * B * N * D / BF16_OPS_S if B >= TC_MIN_QUERIES
           else 2 * B * N * D / F32_OPS_S)
    return max(nbytes / HBM_BYTES_S, ops) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_500_000)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--batches", default="8,16,17,32,64,96,127,128")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("k3_bf16_sweep: no CUDA card")
    from rag_challenge_2_tpu_torch.ops import stream_topk as sk
    from rag_challenge_2_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    N, D, k = args.rows, args.dim, 30
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    emb = torch.empty(N, D, dtype=torch.bfloat16, device=dev)
    for s in range(0, N, 1 << 18):             # unit rows, a chunk at a time
        x = torch.randn(min(N - s, 1 << 18), D, generator=gen, device=dev)
        emb[s:s + x.shape[0]] = torch.nn.functional.normalize(x)
    q_all = torch.nn.functional.normalize(
        emb[torch.randint(0, N, (128,), generator=gen, device=dev)].float()
        + 0.25 * torch.randn(128, D, generator=gen, device=dev) / D ** 0.5)
    info = dict(device=torch.cuda.get_device_name(0), rows=N, dim=D, k=k)
    print(json.dumps(info), flush=True)
    out = {}
    for B in [int(x) for x in args.batches.split(",") if x]:
        q = q_all[:B].contiguous()
        row = dict(ms=cuda_ms(lambda: sk.stream_topk(q, emb, k), flush, reps=11),
                   bound_ms=bound_ms(B, N, D, k))
        if hasattr(sk, "tc_takes"):
            row["regime"] = sk.plan(B, False, False, N, sk.sm_count(dev), k, 2, D,
                                    emb.data_ptr() % 16 == 0).regime
        if B < TC_MIN_QUERIES and hasattr(sk, "tc_takes"):
            q17 = torch.cat([q, q[:1].expand(TC_MIN_QUERIES - B, D)]).contiguous()
            row["tc17_ms"] = cuda_ms(lambda: sk.stream_topk(q17, emb, k), flush, reps=11)
        row["library_ms"] = cuda_ms(lambda: torch.topk(
            torch.matmul(q.to(torch.bfloat16), emb.T).float(), k, dim=1), flush, reps=5)
        if args.plain:
            row["plain_ms"] = cuda_ms(lambda: sk.stream_topk_plain(q, emb, k), flush,
                                      reps=3)
        kv, ki = sk.stream_topk(q, emb, k)
        exact = (q.double()[:, None, :] * emb[ki.long()].double()).sum(-1)
        row["max_err_f64"] = (kv.double() - exact).abs().max().item()
        out[f"B={B}"] = row
        print(f"K3 bf16 N={N} B={B}: " + "  ".join(
            f"{a} {b:.4g}" if isinstance(b, float) else f"{a} {b}" for a, b in row.items()),
            flush=True)
    print(json.dumps(dict(info, by_batch=out)))


if __name__ == "__main__":
    main()
