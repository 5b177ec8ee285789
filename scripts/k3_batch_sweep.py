#!/usr/bin/env python3
"""Kernel K3's int8 forms on one routed slot of the 10M hybrid, by batch.

    python3 scripts/k3_batch_sweep.py [--rows 1666666] [--dim 1024] [--seed 0]

Runs ``rag_challenge_2_tpu_torch.ops.stream_topk.stream_topk`` on the card
over a random int8 store of ``--rows`` x ``--dim`` codes with per-row
scales, k = 30, for 1-pass batches from 1 to 128 and 2-pass batches from 4
to 64.  Each time is the median of 25 CUDA-event timings with the L2 cache
flushed and the device parked behind a spin before each (so the host has
queued the launch before the device reaches it).  Per batch it prints the planner's regime and query
tile and the time, then one JSON line with all of them.  It takes the
package from the checkout it sits in, so two checkouts compare side by
side in one session.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ONE_PASS = (1, 4, 16, 17, 24, 32, 48, 64, 65, 127, 128)
TWO_PASS = (4, 8, 9, 16, 32, 33, 64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_666_666)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("k3_batch_sweep: no CUDA card")
    from rag_challenge_2_tpu_torch.ops import stream_topk as sk
    from rag_challenge_2_tpu_torch.ops.quant import quantize_query_2pass, quantize_rows
    from rag_challenge_2_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    N, D = args.rows, args.dim
    emb = torch.randint(-127, 128, (N, D), generator=gen, device=dev, dtype=torch.int8)
    rs = torch.rand(N, generator=gen, device=dev) * 1e-2 + 1e-3
    q = torch.randn(max(ONE_PASS + TWO_PASS), D, generator=gen, device=dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"K3 from {Path(sk.__file__).parents[2]}, large query tiles "
          f"{sk.LARGE_QUERY_TILES}", flush=True)
    out = {}
    for two, batches in ((False, ONE_PASS), (True, TWO_PASS)):
        for B in batches:
            if two:
                qq, s_hi, s_lo = quantize_query_2pass(q[:B].contiguous())
                kw = dict(q_scale=s_hi, q_scale_lo=s_lo)
            else:
                qq, qs = quantize_rows(q[:B].contiguous())
                kw = dict(q_scale=qs)
            pl = sk.plan(B, two, True, N, sms)
            ms = cuda_ms(lambda: sk.stream_topk(qq, emb, 30, row_scale=rs, **kw), flush)
            name = f"{'2-pass ' if two else ''}B={B}"
            out[name] = dict(regime=pl.regime, query_tile=pl.query_tile, ms=ms)
            print(f"K3 int8 N={N} D={D} k=30 {name}: {pl.regime} tile {pl.query_tile}  "
                  f"{ms:.4f} ms", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
