#!/usr/bin/env python3
"""Kernel K2 (posting-span gather) beside the kernel it replaced and beside
its TMA form, at shapes like the main path's, under one timer.

    python3 scripts/k2_sweep.py [--seed 0] [--skip-edges]

Builds ``csrc/span_gather.cu`` (the port's kernel), ``scripts/k2_parent.cu``
(the kernel it replaced) and ``scripts/k2_tma.cu`` (the same gather with
its loads as TMA bulk copies into a ring of shared-memory stages, planned
by :func:`tma_plan`).  Holds the port's kernel and the parent's bitwise
against the plain version on K2's edge cases (``chip_smoke.k2_edges``) and
all three at every shape, then times them in turns (parent, TMA, kernel,
kernel, TMA, parent), each cold (behind a spin, L2 flushed; median of 25)
and warm (a train of 20 launches), at: a capped CSR (V = 2^18 terms of
1-512 postings, G = 8 x 64 random terms, W = 512, with doc lengths); long
posting lists (W = 4096, G = 8 x 64 terms drawn from 100, the last 8 of
each query padded to start 0); and IVF-like probes (G = 1016 starts on a
32-row grid, W = 600 and 577, row ids and scales).  Prints the card, a
table, then one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the TMA form's geometry (its source's constants)
TMA_MAX_STAGES = 4
TMA_MAX_BLOCKS_PER_SM = 8
SMEM_SM = 233472            # 228 KB of shared memory per SM
SMEM_RESERVED = 1024        # per block, taken by the runtime


@dataclass(frozen=True)
class TmaPlan:
    piece: int
    n_pieces: int
    stage_words: int        # shared-memory words per array and stage
    stages: int             # ring depth
    grid: int               # persistent blocks, <= items
    smem: int


def tma_smem(n_arrays, stage_words, stages):
    """The stages' words, then a barrier, a first position and an edge flag
    per stage (the TMA form's ``carve``)."""
    return stages * n_arrays * stage_words * 4 + TMA_MAX_STAGES * (8 + 8 + 4)


def tma_plan(G, window, n_arrays, sms):
    """The TMA form's cut: the port planner's pieces; a stage holds a
    piece's 16-byte-aligned extension (3 words either side) and the
    realigning reads' 16 bytes past it; one item per block where the items
    fit 8 blocks an SM, else a persistent grid with rings of up to 4
    stages that fit the SM's shared memory."""
    from rag_challenge_2_tpu_torch.ops.span_gather import plan

    cut = plan(G, window, n_arrays)
    stage_words = -(-cut.piece // 4) * 4 + 8
    one = tma_smem(n_arrays, stage_words, 1)
    bps = max(1, min(TMA_MAX_BLOCKS_PER_SM, SMEM_SM // (one + SMEM_RESERVED)))
    grid = min(cut.items, bps * sms)
    stages = min(TMA_MAX_STAGES, -(-cut.items // grid))
    per_sm = -(-grid // sms)
    while stages > 1 and per_sm * (tma_smem(n_arrays, stage_words, stages)
                                   + SMEM_RESERVED) > SMEM_SM:
        stages -= 1
    return TmaPlan(cut.piece, cut.n_pieces, stage_words, stages, grid,
                   tma_smem(n_arrays, stage_words, stages))


_TMA = None


def _tma_lib():
    global _TMA
    if _TMA is None:
        from rag_challenge_2_tpu_torch.utils import kernels

        lib = kernels.load_library("k2_tma", ROOT / "scripts" / "k2_tma.cu")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rc2_span_gather.restype = I
        lib.rc2_span_gather.argtypes = [P, P, P, ctypes.c_longlong, P, I, I, P, P, P,
                                        I, I, I, I, I, I, P]
        _TMA = lib
    return _TMA


def tma_gather(chunk_ids, tf, starts, *, window, dl=None):
    """The TMA form on CUDA tensors, with the port wrapper's contract."""
    import torch

    from rag_challenge_2_tpu_torch.ops.float_scan import sm_count
    from rag_challenge_2_tpu_torch.utils import kernels

    lib = _tma_lib()
    arrays = [chunk_ids, tf] + ([dl] if dl is not None else [])
    G = starts.shape[0]
    buf = torch.empty((len(arrays), G, window), dtype=torch.float32, device=starts.device)
    outs = [buf[0].view(torch.int32)] + [buf[i] for i in range(1, len(arrays))]
    cut = tma_plan(G, window, len(arrays), sm_count(starts.device))
    src = [a.data_ptr() for a in arrays] + [None] * (3 - len(arrays))
    dst = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    rc = lib.rc2_span_gather(*src, chunk_ids.shape[0], starts.data_ptr(), G, window, *dst,
                             cut.piece, cut.n_pieces, cut.stage_words, cut.stages, cut.grid,
                             cut.smem, torch.cuda.current_stream(starts.device).cuda_stream)
    kernels.check_launch(lib, rc, "k2_tma")
    return tuple(outs)


def shapes(dev, gen):
    """``{name: (arrays, starts, window)}`` like the main path's calls."""
    import torch

    import chip_smoke as cs
    from rag_challenge_2_tpu_torch.ops.span_gather import dma_slack

    out = {}
    csr = cs.make_csr(dev, gen, 1_500_000)
    terms = torch.randint(0, csr["V"], (8 * 64,), generator=gen, device=dev)
    out["capped W=512"] = ([csr["chunk_ids"], csr["tf"], csr["dl"]],
                           csr["indptr"][terms].to(torch.int32).contiguous(), csr["W"])
    W = 4096
    counts = torch.randint(1, W + 1, (100,), generator=gen, device=dev)
    indptr = torch.zeros(101, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(counts, 0)
    nnz_pad = -(-(int(indptr[-1]) + dma_slack(W)) // 1024) * 1024
    ids = torch.randint(0, 10_200, (nnz_pad,), generator=gen, device=dev, dtype=torch.int32)
    tf = torch.randint(1, 5, (nnz_pad,), generator=gen, device=dev).float()
    dl = torch.rand(nnz_pad, generator=gen, device=dev)
    st = indptr[torch.randint(0, 100, (8 * 64,), generator=gen, device=dev)]
    st[(torch.arange(8 * 64, device=dev) % 64) >= 56] = 0
    out["long lists W=4096"] = ([ids, tf, dl], st.to(torch.int32).contiguous(), W)
    n_rows = 1_100_000
    rid = torch.randint(0, 1_000_000, (n_rows,), generator=gen, device=dev, dtype=torch.int32)
    scale = torch.rand(n_rows, generator=gen, device=dev)
    lists = (torch.randint(0, 1_000_000 // 32, (1016,), generator=gen, device=dev) * 32)
    for W in (600, 577):
        out[f"IVF-like W={W}"] = ([rid, scale], lists.to(torch.int32).contiguous(), W)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-edges", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("k2_sweep: no CUDA card")
    import chip_smoke as cs
    from rag_challenge_2_tpu_torch.ops.float_scan import sm_count
    from rag_challenge_2_tpu_torch.ops.span_gather import (
        gather_posting_spans, gather_posting_spans_plain, plan)
    from rag_challenge_2_tpu_torch.utils import kernels
    from rag_challenge_2_tpu_torch.utils.timing import cuda_ms, cuda_ms_train

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    contenders = {"parent": cs.k2_parent().gather, "tma": tma_gather,
                  "kernel": gather_posting_spans}
    kernels.build_all(["span_gather"])
    cs.k2_parent()._lib()
    _tma_lib()
    for name in ("span_gather", "k2_parent", "k2_tma"):
        for line in kernels.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {"card": smi.stdout.strip(), "order": "parent, tma, kernel, kernel, tma, parent"}
    if not args.skip_edges:
        out["edge_calls"] = cs.k2_edges(dev, gen)
    order = ["parent", "tma", "kernel", "kernel", "tma", "parent"]
    for sname, (arrays, starts, W) in shapes(dev, gen).items():
        dl = arrays[2] if len(arrays) > 2 else None
        ref = gather_posting_spans_plain(arrays[0], arrays[1], starts, window=W, dl=dl)
        for name, fn in contenders.items():
            got = fn(arrays[0], arrays[1], starts, window=W, dl=dl)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                sys.exit(f"k2_sweep: {name} at {sname} is not bitwise equal to plain")
        res = {k: {"cold": [], "warm": []} for k in contenders}
        for name in order:
            def call(fn=contenders[name]):
                return fn(arrays[0], arrays[1], starts, window=W, dl=dl)

            res[name]["cold"].append(cuda_ms(call, flush, reps=25))
            res[name]["warm"].append(cuda_ms_train(call))
        cut = plan(starts.shape[0], W, len(arrays))
        out[sname] = dict(G=starts.shape[0], W=W, arrays=len(arrays), pieces=cut.n_pieces,
                          chunks=cut.chunks,
                          tma=vars(tma_plan(starts.shape[0], W, len(arrays), sm_count(dev))),
                          ms=res)
        print(f"{sname} (G={starts.shape[0]}, {len(arrays)} arrays), ms cold | warm:", flush=True)
        for name, r in res.items():
            print(f"  {name:7s} {' / '.join(f'{x:.4f}' for x in r['cold'])} | "
                  f"{' / '.join(f'{x:.4f}' for x in r['warm'])}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
