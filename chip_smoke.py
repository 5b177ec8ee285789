#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rag_challenge_2_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--params ENCODER.npz] [--seed 0]

Phases, in order; any failed check raises and the script exits non-zero
without printing a result:

1. environment: the card's name and power limit, torch and CUDA versions;
   no CUDA card → exit non-zero.
2. kernels against their plain PyTorch versions on the card, at the main
   path's shapes and at the edge cases (K1: values within 1e-4 and rows
   identical wherever values are not tied; K2: bitwise), with kernel and
   plain times (median of 25 CUDA-event timings after warm-up, L2 flushed,
   the device parked behind a spin so that the host cannot show through);
   K1 by batch (B = 1 to 64 at 250,000 and 10,240 rows, f32 and bf16), each
   batch held against plain and timed beside its bound and ``matmul`` +
   ``topk``; K1's launches per call (one scoring launch, at most one merge);
   K2 at each main-path shape (here phase 4's capped CSR, W = 512; the
   deployment's in phase 3, the IVF arm's in phase 5): it and its parent's
   kernel (``scripts/k2_parent.cu``) bitwise equal to plain, one device
   kernel per call, cold and warm times of both beside the bound (distinct
   span words read once plus the words written) and the indexing
   yardstick; the kernel must not be slower than its parent's; K2's edge
   cases (every start residue, windows 1 to 10,000, views, both ends).
3. the main path at the deployment's size: six synthetic annual reports
   (about 10,200 chunks of Chinese financial text), embedded by the
   full-width encoder, built, saved, loaded and queried with 16 routed
   hybrid requests of 8 queries; the fused candidates are held against
   the same engine on a CPU copy of the index (plain versions); K2 on the
   BM25 arm's own 16 calls (window = the CSR's ``max_postings``).
4. the main path at scale: 1.5M x 1024 bf16 rows, 6 docs with 3 routed, a
   capped CSR (V = 2^18, window 512), 16 calls of 8 queries; queries/s and
   the bf16 dense recall@10 against an f32 oracle.
5. the IVF probe path (BASELINE config 3): 1M x 1024 clustered rows, an
   IVF built on the card (k-means K = 4096, balanced); K4 (int8 bitwise,
   f32 within 1e-5 / 1e-4, bf16 within 1e-4) and K2 against plain at the
   real probe shape and at edge cases; recall@10/@30 against the exact
   oracle and queries/s at nprobe 2/4/8 (f32) and 4/8 (bf16, int8); the
   engine's ``use_ivf`` arm on phase 3's corpus held against the CPU
   engine in row-range and doc-equality routing; the arm at 1M with a
   per-stage split.
6. the 10M-row int8 scan (BASELINE config 5): K3 against plain on phase
   5's 1M store (f32 / bf16 within 1e-4, rows equal to phase 5's K1
   oracle where untied), by batch across the query tiles (B = 8 to 128)
   beside the bound and ``matmul`` + ``topk``, and at edge cases; 10M x
   1024 rows made on the
   card into a plain int8 and a centroid-residual store, K3 bitwise equal
   to plain there in its large regime, and in the residual forms on one
   hybrid slot's rows at B = 4 / 8 / 9 (small and large regimes); every K3
   time beside its bound; recall@10 against the f32 oracle and queries/s of
   ``int8_topk``, ``approx_topk``, the 2-pass residual scan and the
   rescored scan (gates: plain >= 0.89, rescored >= 0.94 and above
   plain); the engine's int8 arm on phase 3's corpus against the CPU
   engine, ``search_many`` of 16 requests against the CPU engine's and
   against 16 ``search`` calls (f32, bf16 and int8 stores; K3's f32 / bf16
   form on each routed slot, where a block owns less than a tile, against
   plain), and the hybrid at 10M with ``scan_rt`` None
   and 0.95, K3 on each of its routed slots bitwise equal to plain and in
   its small regime (per-regime launch counts).  Then K3's time on one
   slot against the batch size (B = 1 to 128, and 2-pass at 4 / 8 / 9),
   each beside its bound, the hybrid's per-stage split, and the device's
   busy share over one window of calls (``torch.profiler``).
   Each kernel's line also carries its bound (bytes over 3.35 TB/s or
   operations over the card's peak, the larger) and a library yardstick
   (a PyTorch composition computing the same function, timed here only).
7. graph traversal (``ssg``, ``triangulation``, ``hybrid_expansion``), whose
   every hop on an f32 / bf16 store is a K1 or K3 call: (a) both kernels
   at the hop shapes (k = 31; 8, 80 and 160 walkers; 1,700 and 250,000
   rows) against plain, beside the bound and ``matmul`` + ``topk``; (b) the
   three methods on phase 3's corpus, with and without BM25, against the
   CPU engine: fused candidates within 1e-4, paths and
   ``materialize_details`` equal for every walker clear of ties (at most
   1% may be tied; a walker that differs with no tie in its records must
   show one at its hop's cut-off when that hop is scanned again), exact
   launch counts per request, ``search_many`` of 3 stacked
   ``hybrid_expansion`` requests against 3 ``search`` calls, a planted
   chunk's nearest neighbour reached, the per-stage split and busy share, and the
   int8 variant with its plain hops; (c) ``hybrid_expansion`` on phase 4's
   1.5M-row bf16 store, 2 calls against the same hops by ``matmul`` + a
   stable sort, and 8 stacked basic requests against 8 separate calls; (d)
   ``ssg`` and ``hybrid_expansion`` on the 10M int8 store
   with the peak memory over the store under 8 GB; (e) 2, 4 and 8
   concurrent requests through the micro-batcher against separate calls.
   7a, 7b and 7e run after phase 3, 7c after phase 4, 7d inside phase 6.
8. the QA server on the card (right after phase 3, while its full-width
   encoder is the embedder): ``QuestionsProcessor`` with the ``qwen``
   preset's QA settings (parent pages, LLM reranking of 30) and hybrid
   BM25, a scripted stub in the LLM's seat, behind ``QAWebApp``; 16
   questions on the card against the CPU engine over the same index and
   embeddings (retrieval tie-aware, the whole payload and every prompt
   equal), the same over HTTP with 2 ``hybrid_expansion`` and 2 ``ssg``
   asks, the other endpoints, exact K1 / K2 / K3 launches per serial ask,
   8 concurrent asks in one micro-batcher dispatch equal to the serial
   ones; ms per ask, the processor's stages, asks/s serial and at 8
   concurrent, the busy share of one ask.  Any reply carrying ``error``
   fails the run.
9. the ingestion pipeline, the CLI and the end-to-end eval on the card
   (right after phase 8, with its full-width encoder): (a) the README's
   sequence through the port's CLI in subprocesses (parse-pdfs →
   process-reports → query → process-questions → serve + 2 asks over
   HTTP) on copies of ``data/test_set``, with ``--device cuda`` against
   ``--device cpu``; (b) ``Pipeline`` at the deployment size (six synthetic
   reports of ~1,700 chunks, one of them a PDF read by ``minipdf``): every
   stage timed, the card's index equal to the CPU's, three presets
   (``offline`` + BM25: K1 + K2; + ``quantize_int8``: K3 int8 + K2; the
   ``scale10m`` flags: K4 + K2) answering 16 questions each against a
   CPU ``Pipeline`` over the same root, each kernel's first call on this
   path against its plain version, launches per question, busy shares;
   (c) ``add_reports`` of a seventh report into that index (f32 and int8)
   against a fresh build of all seven; (d) ``run_e2e`` over the 17 golden
   questions on the card against the CPU; (e) wide k: ``neighbor_k = 100``
   traversal asks and ``query --top-n 100`` against the CPU, through
   ``ops.topk.wide_topk``.
10. encoder training on the card (right after phase 9, on 9b's corpus):
    (a) one full-width train step (the default ``EncoderConfig``, max_len
    64, batch 64, a batch sampled from the corpus) on the card and on the
    CPU from the same weights, in f32 and bf16 activations: loss, accuracy,
    per-tensor gradient cosine, the parameters after the step (Adam's
    first update is ~ lr * sign(g): elements under 1e-3 of their tensor's
    largest gradient are counted, not compared); the step's CUDA-event time
    beside its bound (its valid-token operations over the bf16 / f32 peak,
    or its weight and AdamW-state bytes), its device kernels and busy
    share; (b) ``Pipeline.create_vector_dbs`` with no saved params: the
    auto-pretrain (300 steps, default ``PretrainConfig``, host teacher),
    loss falling, steps/s, the loop's split between the host's sampler and
    the card's step and its busy share; the ``offline`` + BM25 preset
    answering 9b's 16 questions over the trained index (K1 + K2) against a
    CPU pipeline on the same embeddings; the saved npz through the CPU
    encoder (cos >= 0.99999); ``eval_hybrid_e2e`` with the trained encoder;
    (c) 20 steps with the device teacher (``host_teacher=False``): K2
    launches per step, its scores against ``HostBM25Scorer`` (2e-5); (d)
    ``run_quality_eval`` (the default recipe at 5,000 steps, the ablation
    arms at 200, supervised 2,000), every arm beside
    docs/ENCODER_QUALITY.json, gates: BM25 equal to the CPU's, the default
    recipe's hit@10 >= 0.55 and >= 0.2 above random init; K3 / K2 launches;
    (e) ``train-encoder`` → ``process-reports`` (params loaded) → ``query``
    and ``eval-encoder`` through the CLI in subprocesses.  Each kernel's
    first call on these paths is held against its plain version.
11. the sharded serving path (BASELINE config 5's multi-shard form; right
    after phase 6, whose 10M store and results it takes): (a) an NCCL world
    of one rank, ``sharded_dense_topk`` and the 1 x 1 two-level merge on
    the deployment store against ``dense_topk``, and what NCCL says to two
    ranks on the one card; then one gloo world of 4 ranks, all on cuda:0,
    handed the stores through CUDA IPC: (b) the 10M x 1024 int8 scan of
    127 queries flat over 4 ranks and two-level over 2 x 2, bitwise equal
    to the single-device K3 on every rank, recall@10 and ms a call; (c) an
    IVF of 1,024 lists per shard over phase 5's 1M store (rebuilt from its
    seed): build seconds by rank, recall@10 at nprobe 2 / 4 / 8, the exact
    rows at nprobe = K; (d) ``QueryEngine(hier=...)`` with a row-sharded
    deployment store, a ``ShardedSparseIndex`` and a ``ShardedIVF`` over
    phase 3's 16 requests (dense, + BM25, + the IVF arm at nprobe = K)
    against the single-device card engine, K1-K4 launches a request by
    rank; (e) phase 6c's 10M int8 hybrid through the sharded engine against
    6c's candidates, ms a request.  Four ranks share one card there: the
    times show that the merge is right, not that it scales.
12. the MoE encoder and the parallel train step (right after phase 10, on
    9b's corpus): (a) the full-width encoder with 4 experts (42,757,128
    parameters), card against CPU on 256 of 9b's chunks through
    ``EmbeddingModel.embed``: the share of tokens whose routing (expert
    pair, capacity kept) differs (only at router near-ties), the cosine of
    every row (>= 0.9999) and of the rows clear of such a change; (b)
    phase 3's deployment corpus embedded by it on the card,
    indexed, phase 3's 16 requests (dense, + BM25: K1, K2) against a CPU
    engine over the same embeddings, launches a request, chunks/s beside
    the dense encoder's; (c) one full-width MoE train step (batch 64 x 64),
    card against CPU in f32 activations (loss, accuracy, moe_aux, gradient
    cosines, sure-signed parameters), and in bf16 on the card, each time
    beside its bound (the experts at capacity), kernels and busy share;
    (d) one gloo world of 4 ranks on the card in f32 activations:
    ``data 2 x model 2`` with ``sequence_parallel``, dense and MoE, and
    ``data 1 x pipe 4`` (2 microbatches), each step held against the
    single-device card step on the global batch (loss, per-tensor gradient
    cosine >= 0.9999 and norm within 1e-3, a dense case's gradients within
    1e-4 of each tensor's largest, sure-signed parameters), ms a step by
    rank; (e)
    ``python -m rag_challenge_2_tpu_torch.parallel.dryrun 4 --device cuda``
    (K1 / K2 / K4 on every rank) and ``download-models`` in subprocesses.
13. the last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  Weights are random from ``--seed`` unless a
``save_params`` npz is given.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
COMPANY = "金盘科技"
YEARS = range(2020, 2026)
K1_TOL = 1e-4
# the H100 SXM's published peaks (dense): HBM bytes/s, int8 tensor-core
# operations/s, f32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
F32_OPS_S = 67e12


class SmokeError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing

def cuda_ms(fn, flush, reps=25, warmup=3, spin=True):
    """Median milliseconds of ``fn`` by CUDA events; the L2 cache is
    flushed before each timed call and the device is parked behind a spin
    ahead of the start event, so the host has queued ``fn``'s launches
    before the device reaches them (``utils/timing.py``; ``spin=False`` is
    the unprotected single shot, which times the host for short kernels)."""
    from rag_challenge_2_tpu_torch.utils.timing import cuda_ms as timed

    return timed(fn, flush, reps=reps, warmup=warmup, spin=spin)


def device_us(ev):
    """The device time (us) of a ``torch.profiler`` event that ran on the
    card, 0 for any other: an operator's event carries its kernels' device
    time too, so summing every event counts each kernel twice."""
    import torch

    if ev.device_type != torch.autograd.DeviceType.CUDA:
        return 0
    return getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)


def profile_calls(fn, calls=1, tries=3):
    """``(device kernel names, runtime launch calls)`` of ``calls`` runs of
    ``fn()`` under ``torch.profiler``.  The host waits a moment inside the
    window before the first call, and a window that caught no device
    activity at all is taken again and logged (a window of one short
    kernel once came back empty after the encoder had run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names, launches = [], 0
        events = prof.key_averages()
        for ev in events:
            dev_us = device_us(ev)
            if dev_us:
                names += [ev.key] * ev.count
            elif ev.key.startswith("cudaLaunchKernel"):
                launches += ev.count
        if names:
            break
        log(f"profiler window with no device time: "
            f"{[(ev.key[:40], ev.count) for ev in events][:12]}")
    return names, launches


def device_kernels(fn):
    """Names of the device kernels one ``fn()`` launches."""
    return profile_calls(fn)[0]


def bound(nbytes, ops, peak):
    """The least time for the work, ``(ms, "bytes" or "operations")``: the
    bytes over the HBM rate or the operations over the peak, the larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_bound(N, D, elt, code_rows, B, k, peak, row_arrays=1):
    """K3's bound: the store and its per-row arrays read once, the codes
    read once, B x k results written; 2 x code_rows x N x D operations."""
    nbytes = N * D * elt + 4 * N * row_arrays + code_rows * D * elt + 8 * B * k
    return bound(nbytes, 2 * code_rows * N * D, peak)


def share(ms, bnd):
    return f"{ms:.3f} ms = {100 * bnd[0] / ms:.1f}% of its {bnd[0]:.3f} ms bound ({bnd[1]})"


def library_time(name, fn, flush, **kw):
    """``cuda_ms`` of a PyTorch composition timed beside a kernel as its
    yardstick (the port never calls it); None, with the reason logged,
    where this PyTorch build refuses the composition."""
    try:
        return cuda_ms(fn, flush, **kw)
    except (RuntimeError, NotImplementedError) as e:
        log(f"{name} library yardstick not timed: {str(e).splitlines()[0][:120]}")
        return None


def wall(fn, dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# --------------------------------------------------------------- phase 2

def unit_rows(n, d, gen, dev):
    import torch

    x = torch.randn(n, d, generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def untied(vals, tol):
    """Positions whose value is apart from both neighbours by > 2 tol."""
    import torch

    step = (vals[:, 1:] - vals[:, :-1]).abs()
    inf = torch.full_like(vals[:, :1], float("inf"))
    return torch.minimum(torch.cat([inf, step], 1), torch.cat([step, inf], 1)) > 2 * tol


def compare_k1(name, q, emb, k, mask=None):
    """Kernel vs plain: max abs diff of values, rows where untied."""
    import torch

    from rag_challenge_2_tpu_torch.ops.dense_topk import (
        dense_topk_fused, dense_topk_plain)

    kv, ki = dense_topk_fused(q, emb, k, mask)
    pv, pi = dense_topk_plain(q, emb, k, mask)
    torch.cuda.synchronize()
    check(kv.shape == pv.shape, f"K1 {name}: shape {kv.shape} vs {pv.shape}")
    err = (kv - pv).abs().max().item()
    check(err <= K1_TOL, f"K1 {name}: max abs diff {err} > {K1_TOL}")
    u = untied(pv, K1_TOL)
    check(torch.equal(ki[u], pi[u]), f"K1 {name}: untied rows differ")
    return err, kv, ki


def k2_parent():
    """K2 as it stood before its redesign (``scripts/k2_parent.py``), the
    baseline the redesigned kernel is timed beside; the port never calls it."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import k2_parent as parent

    return parent


def k2_shape(name, arrays, starts_list, W, flush):
    """K2 at one shape of the main path, over the calls that launch it
    (one ``starts`` each): the kernel and the parent's kernel bitwise equal
    to plain on every call, one device kernel per call and the launch count
    one up; cold times (behind a spin, L2 flushed) and warm times (a train
    of 20 launches, L2 warm), each the median over the calls, of the kernel,
    the parent's kernel and the indexing yardstick, taken in turns (parent,
    kernel, kernel, parent); the bound from the distinct span words read once
    plus the words written."""
    import torch

    from rag_challenge_2_tpu_torch.ops.span_gather import (
        gather_posting_spans, gather_posting_spans_plain, plan)
    from rag_challenge_2_tpu_torch.utils.timing import cuda_ms_train

    parent = k2_parent()
    ids, tf = arrays[:2]
    dl = arrays[2] if len(arrays) > 2 else None
    n, na, dev = ids.shape[0], len(arrays), ids.device
    offs = torch.arange(W, device=dev)
    calls = []
    for st in starts_list:
        pos = (st.long()[:, None] + offs).clamp(0, n - 1)
        calls.append(dict(
            new=lambda st=st: gather_posting_spans(ids, tf, st, window=W, dl=dl),
            parent=lambda st=st: parent.gather(ids, tf, st, window=W, dl=dl),
            plain=lambda st=st: gather_posting_spans_plain(ids, tf, st, window=W, dl=dl),
            index=lambda pos=pos: [a[pos] for a in arrays],
            bytes=4 * na * (torch.unique(pos).numel() + st.shape[0] * W) + 4 * st.shape[0]))
    for c in calls:
        before = gather_posting_spans.launches
        got, old, ref = c["new"](), c["parent"](), c["plain"]()
        torch.cuda.synchronize()
        check(gather_posting_spans.launches == before + 1,
              f"K2 {name}: one call must count one launch")
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"K2 {name}: not bitwise equal to plain")
        check(all(torch.equal(a, b) for a, b in zip(old, ref)),
              f"K2 {name}: the parent's kernel is not bitwise equal to plain")
    # one call, one launch: 8 calls make 8 runtime launches, and every
    # device kernel the window caught is the gather (after the encoder has
    # run, the profiler loses some or all device records of such a window;
    # its runtime records stay whole)
    names, launches = profile_calls(calls[0]["new"], calls=8)
    check(launches == 8 and all("gather_spans" in n for n in names),
          f"K2 {name}: one call must be one device kernel: {launches} launches, {names}")
    if len(names) != 8:
        log(f"K2 {name}: the profiler caught {len(names)} of the 8 calls' device kernels")
    # each call timed on its own, cold and in a train of 20 (one call per
    # launch keeps the spin ahead of the host); the medians over the calls
    per = max(3, 25 // len(calls))
    cold = {f: [] for f in ("parent", "new", "index")}
    warm = {f: [] for f in ("parent", "new", "index")}
    for c in calls:
        for f in ("parent", "new", "new", "parent", "index"):
            cold[f].append(cuda_ms(c[f], flush, reps=per))
            warm[f].append(cuda_ms_train(c[f], reps=3 if len(calls) > 1 else 7))
    pms = statistics.median(cuda_ms(c["plain"], flush, reps=per) for c in calls)
    G = starts_list[0].shape[0]
    bnd = bound(statistics.median(c["bytes"] for c in calls), 0, F32_OPS_S)
    cut = plan(G, W, na)
    out = dict(G=G, W=W, arrays=na, calls=len(calls), ms=statistics.median(cold["new"]),
               parent_ms=statistics.median(cold["parent"]), plain_ms=pms,
               library_ms=statistics.median(cold["index"]),
               train_ms=statistics.median(warm["new"]),
               parent_train_ms=statistics.median(warm["parent"]),
               library_train_ms=statistics.median(warm["index"]), bound_ms=bnd[0], bound_by=bnd[1],
               pieces=cut.n_pieces, chunks=cut.chunks,
               device_kernel=names[0][:60] if names else None, kernels_caught=len(names))
    check(out["ms"] <= out["parent_ms"] * 1.05,
          f"K2 {name}: the kernel is slower than the parent's: {out}")
    log(f"K2 {name} (G={G}, W={W}, {na} arrays, {len(calls)} calls; {cut.n_pieces} "
        f"piece(s) a span, {cut.chunks} chunk(s) a thread): bitwise equal, one device kernel. "
        f"Cold: kernel {share(out['ms'], bnd)}, parent's kernel {out['parent_ms']:.4f}, "
        f"indexing {out['library_ms']:.4f}, plain {pms:.4f} ms; warm train: kernel "
        f"{out['train_ms']:.4f}, parent's {out['parent_train_ms']:.4f}, indexing "
        f"{out['library_train_ms']:.4f} ms")
    return out


def k2_edges(dev, gen):
    """K2 and the parent's kernel bitwise equal to plain on the cases the
    main path does not reach: every start residue mod 4, windows off the
    16-byte grid and longer than one piece, spans crossing 0 and the
    array's end (the word path), unaligned views, a G that is not a
    multiple of the grid, and 2 or 3 arrays."""
    import torch

    from rag_challenge_2_tpu_torch.ops.span_gather import (
        gather_posting_spans, gather_posting_spans_plain)

    parent = k2_parent()
    n = 70_003
    ids = torch.randint(0, 1 << 30, (n,), generator=gen, device=dev, dtype=torch.int32)
    tf = torch.rand(n, generator=gen, device=dev)
    dl = torch.rand(n, generator=gen, device=dev)
    cases = 0
    for W in (1, 3, 4, 5, 512, 577, 4096, 10_000):
        inner = torch.randint(0, n - W, (1016,), generator=gen, device=dev)
        for r in range(4):
            st = (inner - inner % 4 + r).to(torch.int32)
            for view in (0, 1, 3):                 # ids[view:] and friends
                for a in ([ids[view:], tf[view:]], [ids[view:], tf[view:], dl[view:]]):
                    for s in (st[:529], st):       # G = 529: not a multiple of the grid
                        s = s.clamp(max=a[0].shape[0] - 1).contiguous()
                        ref = gather_posting_spans_plain(*a[:2], s, window=W,
                                                         dl=a[2] if len(a) > 2 else None)
                        for fn in (gather_posting_spans, parent.gather):
                            got = fn(*a[:2], s, window=W, dl=a[2] if len(a) > 2 else None)
                            check(all(torch.equal(x, y) for x, y in zip(got, ref)),
                                  f"K2 edge W={W} residue {r} view {view} {len(a)} arrays "
                                  f"G={s.shape[0]} ({fn.__module__}): not bitwise equal")
                        cases += 1
        # spans crossing 0 and the end of the arrays: the word path
        st = torch.tensor([-W - 5, -W, -3, -1, 0, 1, n - W - 1, n - W, n - 3, n - 1, n,
                           n + 7], device=dev, dtype=torch.int32)
        ref = gather_posting_spans_plain(ids, tf, st, window=W, dl=dl)
        got = gather_posting_spans(ids, tf, st, window=W, dl=dl)
        check(all(torch.equal(x, y) for x, y in zip(got, ref)),
              f"K2 edge W={W}: spans crossing the ends not bitwise equal")
        cases += 1
    torch.cuda.synchronize()
    log(f"K2 edge cases: {cases} calls bitwise equal to plain (windows 1-10,000, every "
        f"start residue mod 4, views at +0 / +1 / +3 words, spans crossing both ends)")
    return cases


def phase2_kernels(dev, flush, gen, csr):
    import torch

    from rag_challenge_2_tpu_torch.ops.dense_topk import (
        dense_topk_fused, dense_topk_plain)
    from rag_challenge_2_tpu_torch.ops.span_gather import (
        gather_posting_spans, gather_posting_spans_plain)
    from rag_challenge_2_tpu_torch.utils import kernels
    from rag_challenge_2_tpu_torch.utils.timing import cuda_ms_train

    log("== phase 2: kernels vs plain PyTorch on the card")
    t0 = time.perf_counter()
    kernels.build_all()                  # one nvcc per source, in parallel
    for name in sorted(p.stem for p in kernels.CSRC.glob("*.cu")):
        kernels.load_library(name)
    log(f"built kernels ({', '.join(sorted(kernels.build_logs))}) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, rep in kernels.build_logs.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    out = {"k1": [], "k2": []}
    B, D, k = 8, 1024, 30
    q = unit_rows(B, D, gen, dev)
    k1_err = 0.0
    for N in (10_240, 250_000):
        base = unit_rows(N, D, gen, dev)
        for dt in (torch.float32, torch.bfloat16):
            emb = base.to(dt)
            err, _, _ = compare_k1(f"N={N} {dt}", q, emb, k)
            k1_err = max(k1_err, err)
            ms = cuda_ms(lambda: dense_topk_fused(q, emb, k), flush)
            pms = cuda_ms(lambda: dense_topk_plain(q, emb, k), flush)
            # yardstick: one matmul in the store's type, then torch.topk
            lib = library_time("K1", lambda: torch.topk(
                torch.matmul(q.to(dt), emb.T).float(), k, dim=1), flush)
            bnd = bound(N * D * emb.element_size() + B * D * 4 + 8 * B * k,
                        2 * B * N * D, F32_OPS_S)
            gbs = N * D * emb.element_size() / ms / 1e6
            out["k1"].append(dict(N=N, dtype=str(dt).split(".")[1], err=err,
                                  ms=ms, plain_ms=pms, gb_s=gbs, bound_ms=bnd[0],
                                  bound_by=bnd[1], library_ms=lib))
            log(f"K1 B={B} N={N} D={D} k={k} {dt}: max|diff| {err:.3g}  "
                f"kernel {share(ms, bnd)} ({gbs:.0f} GB/s)  plain {pms:.4f} ms  "
                f"matmul + topk {lib if lib is None else f'{lib:.4f}'} ms")
    # edge cases: each compared with plain, then timed
    N = 10_000                                    # not a multiple of the tile
    cases = {
        "ragged N=10000 + mask": (unit_rows(N, D, gen, dev), k,
                                  torch.rand(N, generator=gen, device=dev) > 0.3),
        "k=30 > N=20": (unit_rows(20, D, gen, dev), 30, None),
        "all masked N=1000": (unit_rows(1000, D, gen, dev), k,
                              torch.zeros(1000, dtype=torch.bool, device=dev)),
        "ties N=3x700": (unit_rows(700, D, gen, dev).repeat(3, 1), k, None),
    }
    for name, (emb, kk, mask) in cases.items():
        err, kv, ki = compare_k1(name, q, emb, kk, mask)
        k1_err = max(k1_err, err)
        if name.startswith("k=30"):
            check(kv.shape == (B, 20), "K1 k > N: k_eff must be N")
        if name.startswith("all masked"):
            check(bool((kv == -3.0e38).all()), "K1 all masked: values must be NEG_INF")
            check(torch.equal(ki, torch.arange(k, device=dev, dtype=torch.int32)
                              .expand(B, k)), "K1 all masked: lowest rows first")
        if name.startswith("ties"):
            same = kv[:, 1:] == kv[:, :-1]
            check(bool(same.any()) and bool((ki[:, 1:][same] > ki[:, :-1][same]).all()),
                  "K1 ties: equal values must come in ascending row order")
        ms = cuda_ms(lambda: dense_topk_fused(q, emb, kk, mask), flush)
        pms = cuda_ms(lambda: dense_topk_plain(q, emb, kk, mask), flush)
        log(f"K1 {name}: max|diff| {err:.3g}  kernel {ms:.4f} ms  plain {pms:.4f} ms")
    # K1 by batch: each batch held against plain, then timed beside its
    # bound and matmul + topk; the planner's cut shows one store pass
    from rag_challenge_2_tpu_torch.ops.dense_topk import plan as k1_plan
    from rag_challenge_2_tpu_torch.ops.float_scan import sm_count

    out["k1_by_batch"] = {}
    q64 = unit_rows(64, D, gen, dev)
    for N in (250_000, 10_240):
        base = unit_rows(N, D, gen, dev)
        for dt in (torch.bfloat16, torch.float32):
            emb = base.to(dt)
            name = str(dt).split(".")[1]
            for Bq in (1, 4, 8, 16, 32, 64):
                qb = q64[:Bq].contiguous()
                err, _, _ = compare_k1(f"N={N} {name} B={Bq}", qb, emb, k)
                k1_err = max(k1_err, err)
                cut = k1_plan(Bq, N, k, dt == torch.bfloat16, sm_count(dev))
                check(cut.store_passes == 1 and cut.query_tile >= Bq
                      and (cut.n_chunks - 1) * cut.rows_per_chunk < N
                      <= cut.n_chunks * cut.rows_per_chunk,
                      f"K1 N={N} B={Bq}: the grid must cover each row once: {cut}")
                ms = cuda_ms(lambda: dense_topk_fused(qb, emb, k), flush, reps=11)
                lib = library_time("K1", lambda: torch.topk(
                    torch.matmul(qb.to(dt), emb.T).float(), k, dim=1), flush, reps=7)
                bnd = bound(N * D * emb.element_size() + Bq * D * 4 + 8 * Bq * k,
                            2 * Bq * N * D, F32_OPS_S)
                out["k1_by_batch"][f"N={N} {name} B={Bq}"] = dict(
                    ms=ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib, err=err,
                    query_tile=cut.query_tile, chunks=cut.n_chunks)
                log(f"K1 by batch N={N} {name} B={Bq} (tile {cut.query_tile}, "
                    f"{cut.n_chunks} chunks): max|diff| {err:.3g}  kernel {share(ms, bnd)}  "
                    f"matmul + topk {lib if lib is None else f'{lib:.4f}'} ms")
    # one scoring launch and at most one merge launch per call
    names = device_kernels(lambda: dense_topk_fused(q, emb, k))
    log(f"K1 device kernels per call: {[n[-40:] for n in names]}")
    check(len(names) <= 2 and sum("scan_float" in n for n in names) == 1
          and all("scan_float" in n or "merge_lists" in n for n in names),
          f"K1 must be one scoring launch and at most one merge launch: {names}")
    log(f"K1 max|diff| over all cases {k1_err:.3g}")

    ids, tf, dl, indptr, V, W = (csr[x] for x in
                                 ("chunk_ids", "tf", "dl", "indptr", "V", "W"))
    terms = torch.randint(0, V, (8 * 64,), generator=gen, device=dev)
    starts = indptr[terms].to(torch.int32).contiguous()
    got = gather_posting_spans(ids, tf, starts, window=W)
    ref = gather_posting_spans_plain(ids, tf, starts, window=W)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, ref)),
          "K2 (without dl): not bitwise equal to plain")
    k2 = k2_shape("phase 2, capped CSR V=2^18, with dl", [ids, tf, dl], [starts], W, flush)
    # the same call timed so that the host shows: the unprotected single shot
    # (the start event reaches an idle device while the host still prepares
    # the launch) beside the least launch and the wrapper's host time
    pos = (starts.long()[:, None] + torch.arange(W, device=dev)).clamp(0, ids.shape[0] - 1)

    def k2_call():
        return gather_posting_spans(ids, tf, starts, window=W, dl=dl)

    t0 = time.perf_counter()
    for _ in range(200):
        k2_call()
    host_ms = (time.perf_counter() - t0) / 200 * 1e3      # the wrapper, no synchronise
    torch.cuda.synchronize()
    both = dict(kernel_host_ms=host_ms,
                kernel_single_shot=cuda_ms(k2_call, flush, spin=False),
                library_single_shot=cuda_ms(lambda: [a[pos] for a in (ids, tf, dl)],
                                            flush, spin=False),
                empty_launch_train=cuda_ms_train(lambda: flush[:1].zero_()))
    log(f"K2 unprotected single shot (ms): kernel {both['kernel_single_shot']:.4f}, "
        f"indexing {both['library_single_shot']:.4f}; the least launch (a 1-byte fill, "
        f"train): {both['empty_launch_train']:.4f}; the wrapper's host time per call "
        f"{host_ms:.4f} (what an unprotected timing reads when the host is late)")
    out["k2"].append(dict(nnz=ids.shape[0], **k2, **both))
    out["k2_edges"] = k2_edges(dev, gen)
    out["k1_err"] = k1_err
    return out


# --------------------------------------------------------------- phase 3

METRICS = ["营业收入", "净利润", "归属于上市公司股东的净利润", "经营活动产生的现金流量净额",
           "研发投入", "毛利率", "总资产", "净资产", "基本每股收益", "资产负债率",
           "存货", "应收账款", "销售费用", "管理费用", "海外收入", "储能业务收入",
           "变压器产量", "合同负债", "在手订单", "现金分红"]
SEGMENTS = ["干式变压器", "储能系统", "数字化工厂", "海外市场", "新能源", "轨道交通",
            "数据中心", "风电", "光伏", "电力电子"]
TEMPLATES = [
    "{y}年，公司{m}为{v:.2f}亿元，同比{d}{p:.2f}%。",
    "报告期内，{s}板块实现{m}{v:.2f}亿元，占比{p:.1f}%。",
    "{s}业务方面，公司持续加大投入，{m}较上年{d}{p:.2f}个百分点。",
    "截至{y}年12月31日，公司{m}为{v:.2f}亿元。",
    "公司在{s}领域的{m}达到{v:.2f}亿元，主要系订单增长所致。",
    "{y}年第{q}季度{m}为{v:.2f}亿元，环比{d}{p:.1f}%。",
]


def make_corpus(rng, chunks_per_doc=1700, chunks_per_page=6):
    """Six annual reports in the chunked-report contract, company
    金盘科技, years 2020-2025; every chunk carries a unique tag."""
    reports = []
    for d, year in enumerate(YEARS):
        chunks, pages = [], []
        for i in range(chunks_per_doc):
            sent = []
            for _ in range(int(rng.integers(3, 7))):
                t = TEMPLATES[int(rng.integers(len(TEMPLATES)))]
                sent.append(t.format(
                    y=year, m=METRICS[int(rng.integers(len(METRICS)))],
                    s=SEGMENTS[int(rng.integers(len(SEGMENTS)))],
                    v=float(rng.uniform(0.1, 90)), p=float(rng.uniform(0.1, 60)),
                    d="增长" if rng.random() < 0.7 else "下降",
                    q=int(rng.integers(1, 5))))
            sent.append(f"（编号r{year}x{i:04d}）")
            chunks.append({"page": i // chunks_per_page + 1, "text": "".join(sent),
                           "id": i, "type": "content"})
        for p in range(-(-chunks_per_doc // chunks_per_page)):
            pages.append({"page": p + 1, "text": "\n".join(
                c["text"] for c in chunks[p * chunks_per_page:(p + 1) * chunks_per_page])})
        reports.append({
            "metainfo": {"sha1_name": f"J{year}_jinpan", "company_name": COMPANY,
                         "year": year},
            "content": {"pages": pages, "chunks": chunks},
        })
    return reports


def make_requests(rng, n_requests=16, per_request=8):
    reqs = []
    for r in range(n_requests):
        year = 2021 + r % 4
        ms = rng.permutation(len(METRICS))[:per_request]
        texts = [f"{year}年{COMPANY}{METRICS[m]}是多少？" for m in ms]
        reqs.append((texts[0], texts))
    return reqs


def same_candidates(a, b, tol):
    """Fused candidates of two engines: scores within tol position by
    position, keys identical up to the order inside groups of scores tied
    within tol.  Returns the number of such reordered groups."""
    import torch

    a, b = a.to("cpu"), b.to("cpu")
    err = (a.score - b.score).abs().max().item()
    check(err <= tol, f"fused scores differ by {err}")
    ka, kb = a.key.tolist(), b.key.tolist()
    sb = b.score.tolist()
    reordered, i = 0, 0
    while i < len(kb):
        j = i + 1
        while j < len(kb) and abs(sb[j] - sb[j - 1]) <= 2 * tol:
            j += 1
        if j < len(kb):                 # a tie group cut by top_n is free
            check(set(ka[i:j]) == set(kb[i:j]),
                  f"fused keys differ at ranks {i}..{j}: {ka[i:j]} vs {kb[i:j]}")
            reordered += ka[i:j] != kb[i:j]
        i = j
    fields = list(zip(a.n_queries.tolist(), a.n_methods.tolist()))
    ref = dict(zip(kb, zip(b.n_queries.tolist(), b.n_methods.tolist())))
    for key, f in zip(ka, fields):
        check(key not in ref or ref[key] == f,
              f"fused hit/method counts differ for key {key}")
    return reordered


def k2_deployment(idx, eng, requests, cfg, model):
    """K2 at the deployment's own shape: the calls the BM25 arm makes for
    the 16 routed requests, recorded as the arm launches them (starts from
    ``encode_queries_host`` then ``indptr[terms]``, the window from the
    CSR's ``max_postings``), then held and timed by :func:`k2_shape`."""
    import torch

    from rag_challenge_2_tpu_torch.ops import bm25 as bm25_mod
    from rag_challenge_2_tpu_torch.retrieval.engine import bm25_hits
    from rag_challenge_2_tpu_torch.retrieval.routing import extract_years_from_question

    seen = []
    real = bm25_mod.gather_posting_spans

    def recorder(chunk_ids, tf, starts, *, window, dl=None):
        seen.append((starts.clone(), window, dl is not None))
        return real(chunk_ids, tf, starts, window=window, dl=dl)

    bm25_mod.gather_posting_spans = recorder
    try:
        for question, qtexts in requests:
            years = extract_years_from_question(question)
            req = eng.prepare(model.embed_device(qtexts), COMPANY, question, years, cfg,
                              qtexts)
            bm25_hits(idx, req, cfg, eng.window)
    finally:
        bm25_mod.gather_posting_spans = real
    sp = idx.sparse
    check(len(seen) == len(requests), f"K2: {len(seen)} BM25 calls for {len(requests)} requests")
    W = seen[0][1]
    check(all(w == W and has_dl == (sp.dl is not None) for _, w, has_dl in seen)
          and W == max(sp.max_postings, 1), "K2: the BM25 arm's window is max_postings")
    terms = [st.shape[0] for st, _, _ in seen]
    log(f"K2 at the deployment: {len(seen)} calls (one per request) of G = {terms[0]} "
        f"starts, window = max_postings = {W}, nnz_pad {sp.chunk_ids.shape[0]}")
    arrays = [sp.chunk_ids, sp.tf] + ([sp.dl] if sp.dl is not None else [])
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=sp.chunk_ids.device)
    out = k2_shape("deployment BM25", arrays, [st for st, _, _ in seen], W, flush)
    del flush
    return out


def phase3_main_path(dev, model, rng, work, chunks_per_doc=1700):
    import numpy as np
    import torch

    from rag_challenge_2_tpu_torch.index import build_corpus_index, load_index, save_index
    from rag_challenge_2_tpu_torch.ops.dense_topk import dense_topk_fused
    from rag_challenge_2_tpu_torch.ops.span_gather import gather_posting_spans
    from rag_challenge_2_tpu_torch.retrieval import QueryEngine, SearchConfig
    from rag_challenge_2_tpu_torch.retrieval.engine import (
        bm25_hits, dense_hits, fuse_blocks)
    from rag_challenge_2_tpu_torch.retrieval.routing import extract_years_from_question

    log("== phase 3: main path at the deployment's size")
    reports = make_corpus(rng, chunks_per_doc)
    texts = [c["text"] for r in reports for c in r["content"]["chunks"]]
    embs, t_emb = wall(lambda: model.embed(texts, batch_size=256), dev)
    log(f"corpus: {len(reports)} reports, {len(texts)} chunks; embedded in "
        f"{t_emb:.2f} s ({len(texts) / t_emb:.0f} chunks/s, full-width encoder)")
    check(np.isfinite(embs).all() and embs.shape == (len(texts), model.cfg.out_dim),
          "corpus embeddings must be finite [n, out_dim]")
    per_doc, s = [], 0
    for r in reports:
        n = len(r["content"]["chunks"])
        per_doc.append(embs[s:s + n])
        s += n
    (idx0, meta0), t_build = wall(
        lambda: build_corpus_index(reports, per_doc, device=dev), dev)
    path = work / "index.npz"
    save_index(path, idx0, meta0)
    del idx0
    (idx, meta), t_load = wall(lambda: load_index(path, device=dev), dev)
    log(f"build {t_build:.2f} s, save+load {t_load:.2f} s, n_pad {idx.n_pad}, "
        f"nnz_pad {idx.sparse.chunk_ids.shape[0]}, max_postings {idx.sparse.max_postings}")
    eng = QueryEngine(idx, meta)
    cfg = SearchConfig(method="basic", top_k=30, top_n=30, use_bm25=True,
                       bm25_top_k=30)
    cfg_sum = SearchConfig(method="basic", top_k=30, top_n=30, use_bm25=True,
                           bm25_top_k=30, fuse_mode="sum", dense_weight=0.5)
    requests = make_requests(rng)
    sha_of_doc = [d.sha1 for d in meta.docs]

    def run_all(c):
        out = []
        for question, qtexts in requests:
            years = extract_years_from_question(question)
            qe = model.embed_device(qtexts)
            cands = eng.search(qe, COMPANY, question, years, c, query_texts=qtexts)
            out.append((years, qe, cands, eng.materialize(cands, c)))
        return out

    dense_topk_fused.launches = 0
    gather_posting_spans.launches = 0
    run_all(cfg)                                   # warm-up
    results, t_e2e = wall(lambda: run_all(cfg), dev)
    launches = {"dense_topk": dense_topk_fused.launches,
                "span_gather": gather_posting_spans.launches}
    log(f"main path launches: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    nq = sum(len(t) for _, t in requests)
    log(f"end to end (embed + route + search + materialize): {nq} queries in "
        f"{t_e2e * 1e3:.1f} ms = {nq / t_e2e:.1f} queries/s, "
        f"{t_e2e / len(requests) * 1e3:.2f} ms/request")

    # routing: every hit lies in a routed document
    for years, _, _, res in results:
        routed = {sha_of_doc[d] for d in eng.routed_docs(COMPANY, "", years)}
        check(len(routed) == 3, f"years {years} must route 3 of 6 docs")
        check(res and all(r["source_sha1"] in routed for r in res),
              f"unrouted hit for years {years}")
        check(all(np.isfinite(r["distance"]) for r in res), "non-finite score")

    # planted: a query equal to a chunk's text returns that chunk at rank 1
    offsets = np.cumsum([0] + [len(r["content"]["chunks"]) for r in reports])
    for d, i in ((1, 17), (3, chunks_per_doc // 2), (4, chunks_per_doc - 1)):
        row = int(offsets[d] + i)
        text = meta.chunk_texts[row]
        qe = model.embed_device([text])
        res = eng.materialize(eng.search(
            qe, COMPANY, text, [reports[d]["metainfo"]["year"]], cfg,
            query_texts=[text]), cfg)
        check(res[0]["rep_row"] == row,
              f"planted chunk {row} not at rank 1: {res[0]['rep_row']}")
    log("planted chunks at rank 1: ok")

    # the same engine on a CPU copy of the index runs the plain versions
    cpu_eng = QueryEngine(idx.to("cpu"), meta)
    reordered = 0
    for c in (cfg, cfg_sum):
        res_c = results if c is cfg else run_all(c)
        for (question, qtexts), (years, qe, cands, _) in zip(requests, res_c):
            ref = cpu_eng.search(qe.cpu(), COMPANY, question, years, c,
                                 query_texts=qtexts)
            reordered += same_candidates(cands, ref, 1e-4)
    log(f"GPU engine == CPU plain engine on all {len(requests)} requests in "
        f"max and sum (dense_weight 0.5) fusion; tie groups reordered: {reordered}")

    # per-stage split over the 16 requests (synchronised after each stage)
    stages = dict(embed=0.0, route=0.0, dense=0.0, bm25=0.0, fuse=0.0,
                  materialize=0.0)
    for question, qtexts in requests:
        years = extract_years_from_question(question)
        qe, t = wall(lambda: model.embed_device(qtexts), dev)
        stages["embed"] += t
        req, t = wall(lambda: eng.prepare(qe, COMPANY, question, years, cfg,
                                          qtexts), dev)
        stages["route"] += t
        bd, t = wall(lambda: dense_hits(idx, req, cfg, eng.window), dev)
        stages["dense"] += t
        bb, t = wall(lambda: bm25_hits(idx, req, cfg, eng.window), dev)
        stages["bm25"] += t
        fused, t = wall(lambda: fuse_blocks(idx, [bd, bb], cfg), dev)
        stages["fuse"] += t
        _, t = wall(lambda: eng.materialize(fused, cfg), dev)
        stages["materialize"] += t
    per_req = {k: v / len(requests) * 1e3 for k, v in stages.items()}
    log("per-stage ms/request: " + ", ".join(f"{k} {v:.3f}" for k, v in per_req.items()))
    k2 = k2_deployment(idx, eng, requests, cfg, model)
    # what phase 5 drives the engine's IVF arm with
    ctx = dict(eng=eng, requests=[(question, qtexts, years, qe)
                                  for (question, qtexts), (years, qe, _, _)
                                  in zip(requests, results)])
    return dict(launches=launches, chunks=len(texts), embed_chunks_s=len(texts) / t_emb,
                qps_e2e=nq / t_e2e, ms_per_request=t_e2e / len(requests) * 1e3,
                stage_ms=per_req, reordered_ties=reordered, k2=k2), ctx


# --------------------------------------------------------------- phase 4

def make_csr(dev, gen, n_rows, V_BITS=18, W=512):
    """A capped CSR in the build's layout: V = 2^V_BITS terms with 1..W
    postings each, the span-gather slack, per-posting doc lengths."""
    import torch

    from rag_challenge_2_tpu_torch.ops.span_gather import dma_slack

    V = 1 << V_BITS
    counts = torch.randint(1, W + 1, (V,), generator=gen, device=dev)
    indptr = torch.zeros(V + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(counts, 0)
    nnz = int(indptr[-1])
    nnz_pad = -(-(nnz + dma_slack(W)) // 1024) * 1024
    chunk_ids = torch.randint(0, n_rows, (nnz_pad,), generator=gen, device=dev,
                              dtype=torch.int32)
    tf = torch.randint(1, 5, (nnz_pad,), generator=gen, device=dev).float()
    chunk_len = torch.randint(50, 500, (n_rows,), generator=gen, device=dev).float()
    dl = chunk_len[chunk_ids.long()]
    return dict(V=V, W=W, indptr=indptr.to(torch.int32), chunk_ids=chunk_ids,
                tf=tf, dl=dl, df=counts.float(), chunk_len=chunk_len,
                nnz=nnz, dma_pad=nnz_pad - nnz)


def phase4_scale(dev, gen, csr, N=1_500_000, D=1024):
    import numpy as np
    import torch

    from rag_challenge_2_tpu_torch.index.schema import CorpusIndex, SparseIndex
    from rag_challenge_2_tpu_torch.ops.dense_topk import (
        dense_topk_fused, dense_topk_plain)
    from rag_challenge_2_tpu_torch.ops.span_gather import gather_posting_spans
    from rag_challenge_2_tpu_torch.retrieval import Request, SearchConfig, search_device
    from rag_challenge_2_tpu_torch.retrieval.engine import (
        bm25_hits, dense_hits, fuse_blocks)

    log(f"== phase 4: main path at scale ({N} x {D} bf16)")
    N_DOCS, Q_BATCH, NQ, T, REPS = 6, 8, 127, 64, 16
    emb32 = torch.empty((N, D), device=dev)
    for s in range(0, N, 250_000):
        n = min(250_000, N - s)
        emb32[s:s + n] = unit_rows(n, D, gen, dev)
    q32 = unit_rows(NQ, D, gen, dev)
    _, oracle = dense_topk_plain(q32, emb32, 10)          # f32 oracle
    emb = emb32.to(torch.bfloat16)
    del emb32
    torch.cuda.empty_cache()

    rows = torch.arange(N, dtype=torch.int32, device=dev)
    per_doc = N // N_DOCS
    doc_id = rows // per_doc
    sparse = SparseIndex(
        indptr=csr["indptr"], chunk_ids=csr["chunk_ids"], tf=csr["tf"],
        df=csr["df"], chunk_len=csr["chunk_len"],
        avgdl=csr["chunk_len"].mean(), dl=csr["dl"], vocab_bits=18,
        max_postings=csr["W"], dma_pad=csr["dma_pad"])
    idx = CorpusIndex(
        emb=emb, doc_id=doc_id, page=rows % 500 + 1, year=2020 + doc_id,
        company_id=torch.zeros_like(rows), kind=torch.zeros_like(rows),
        page_seg=rows // 4, chunk_in_doc=rows % per_doc,
        valid=torch.ones(N, dtype=torch.bool, device=dev), sparse=sparse,
        n_chunks=N, n_pages=N // 4, n_docs=N_DOCS, dim=D)
    doc_masks = torch.stack([doc_id == d for d in range(N_DOCS)])
    doc_valid = np.array([True, True, True, False, False, False])
    row_slot = torch.where(doc_id < 3, doc_id, N_DOCS).to(torch.int32)
    ws = np.arange(N_DOCS, dtype=np.int32) * per_doc
    wl = np.full(N_DOCS, per_doc, np.int32)
    cfg = SearchConfig(method="basic", top_k=30, max_queries=Q_BATCH,
                       max_docs=N_DOCS, top_n=30, use_bm25=True, bm25_top_k=30)
    q_valid = torch.ones(Q_BATCH, dtype=torch.bool, device=dev)
    q_terms = torch.randint(0, csr["V"], (Q_BATCH, T), generator=gen, device=dev,
                            dtype=torch.int32)
    reqs = [Request(q32[(r * Q_BATCH) % (NQ - Q_BATCH):][:Q_BATCH].contiguous(),
                    q_valid, doc_masks, doc_valid, q_terms, row_slot, ws, wl)
            for r in range(REPS)]

    def window():
        return [search_device(idx, rq, cfg, window=per_doc)[0] for rq in reqs]

    dense_topk_fused.launches = 0
    gather_posting_spans.launches = 0
    window()                                               # warm-up
    runs = []
    for _ in range(3):
        fused, t = wall(window, dev)
        runs.append(t)
    launches = {"dense_topk": dense_topk_fused.launches,
                "span_gather": gather_posting_spans.launches}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched at scale: {launches}")
    t = statistics.median(runs)
    qps = Q_BATCH * REPS / t
    for f in fused:
        keys = f.key[f.key >= 0]
        check(keys.numel() > 0 and bool((keys < 3 * per_doc).all()),
              "scale: hits outside the 3 routed docs")
        check(bool(torch.isfinite(f.score).all()), "scale: non-finite scores")
    stages = dict(dense=0.0, bm25=0.0, fuse=0.0)
    for rq in reqs:
        bd, t1 = wall(lambda: dense_hits(idx, rq, cfg, per_doc), dev)
        bb, t2 = wall(lambda: bm25_hits(idx, rq, cfg, per_doc), dev)
        _, t3 = wall(lambda: fuse_blocks(idx, [bd, bb], cfg), dev)
        stages["dense"] += t1
        stages["bm25"] += t2
        stages["fuse"] += t3
    per_call = {k: v / REPS * 1e3 for k, v in stages.items()}
    # K1 at the full store (64 queries: the largest query tile) against plain
    err, _, _ = compare_k1(f"N={N} bf16 unrouted", q32[:64].contiguous(), emb, 10)
    log(f"K1 vs plain over all {N} rows: max|diff| {err:.3g}")
    got = torch.cat([dense_topk_fused(q32[s:s + 64].contiguous(), emb, 10)[1]
                     for s in range(0, NQ, 64)])
    got, oracle = got.cpu().numpy(), oracle.cpu().numpy()
    recall = float(np.mean([len(set(got[i]) & set(oracle[i])) / 10
                            for i in range(NQ)]))
    log(f"scale launches: {launches}; {Q_BATCH * REPS} queries: median of 3 "
        f"windows {t * 1e3:.2f} ms = {qps:.1f} queries/s "
        f"(runs {', '.join(f'{r * 1e3:.2f}' for r in runs)} ms)")
    log("scale per-stage ms/call: " + ", ".join(f"{k} {v:.3f}" for k, v in per_call.items()))
    log(f"dense bf16 recall@10 vs f32 oracle: {recall:.4f}")
    check(recall >= 0.99, f"bf16 recall@10 {recall} < 0.99")
    ctx = dict(idx=idx, reqs=reqs, per_doc=per_doc, cfg=cfg)   # what phase 7c drives
    return dict(launches=launches, qps=qps, window_ms=[r * 1e3 for r in runs],
                stage_ms=per_call, recall10=recall), ctx


# --------------------------------------------------------------- phase 5

def ivf_data(dev, gen, N, D, n_centers=1024, nq=127):
    """BASELINE config 3's data recipe (bench.py): unit-norm centres; rows
    = centre + (0.35/sqrt D) noise, queries = corpus rows + (0.25/sqrt D)
    noise, all normalised."""
    import torch

    centers = unit_rows(n_centers, D, gen, dev)
    emb = torch.empty((N, D), device=dev)
    for s in range(0, N, 250_000):
        n = min(250_000, N - s)
        a = torch.randint(0, n_centers, (n,), generator=gen, device=dev)
        e = centers[a] + (0.35 / D ** 0.5) * torch.randn(n, D, generator=gen, device=dev)
        emb[s:s + n] = e / e.norm(dim=1, keepdim=True)
    r = torch.randint(0, N, (nq,), generator=gen, device=dev)
    q = emb[r] + (0.25 / D ** 0.5) * torch.randn(nq, D, generator=gen, device=dev)
    return emb, q / q.norm(dim=1, keepdim=True)


def recall_at(got, oracle, k):
    return float(sum(len(set(got[i, :k].tolist()) & set(oracle[i, :k].tolist())) / k
                     for i in range(len(oracle))) / len(oracle))


def query_span(q, dtype):
    """The query as the probe scores it: int8 codes for an int8 store, the
    store's dtype otherwise."""
    import torch

    from rag_challenge_2_tpu_torch.ops.quant import quantize_rows

    return quantize_rows(q)[0] if dtype == torch.int8 else q.to(dtype)


def compare_k4(name, emb, q, starts, W):
    """K4 against its plain version: int8 bitwise, f32 within 1e-5 relative
    / 1e-4 absolute, bf16 within 1e-4 absolute (unit rows)."""
    import torch

    from rag_challenge_2_tpu_torch.ops.probe_scores import (
        probe_span_scores, probe_span_scores_plain)

    got = probe_span_scores(emb, q, starts, window=W)
    ref = probe_span_scores_plain(emb, q, starts, window=W)
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"K4 {name}: shape {got.shape} vs {ref.shape}")
    err = (got - ref).abs().max().item()
    if emb.dtype == torch.int8:
        check(torch.equal(got, ref), f"K4 {name}: int8 not bitwise equal (max {err})")
    elif emb.dtype == torch.float32:
        check(torch.allclose(got, ref, rtol=1e-5, atol=1e-4),
              f"K4 {name}: f32 max|diff| {err}")
    else:
        check(err <= 1e-4, f"K4 {name}: bf16 max|diff| {err} > 1e-4")
    return err


def phase5a_kernels(dev, gen, flush, stores, q, starts, W):
    """K4 and K2 against plain at the probe's real shape, then edge cases."""
    import torch

    from rag_challenge_2_tpu_torch.ops.probe_scores import (
        probe_span_scores, probe_span_scores_plain)
    from rag_challenge_2_tpu_torch.ops.span_gather import (
        gather_posting_spans, gather_posting_spans_plain)

    G = starts.shape[0]
    P = G // q.shape[0]
    # the rows the spans touch: spans of W = max_list rows run past their
    # list into the next ones, and nearby queries probe the same lists, so
    # the spans overlap; the function needs each distinct row once
    n_rows = next(iter(stores.values())).emb_perm.shape[0]
    pos = (starts.long()[:, None] + torch.arange(W, device=dev)).clamp(0, n_rows - 1)
    touched = torch.unique(pos).numel()
    log(f"K4 spans G={G} x W={W}: {touched} distinct rows of {G * W} span rows "
        f"({100 * touched / (G * W):.1f}%)")
    out, k4_err = {"rows_touched": touched}, 0.0
    for name, iv in stores.items():
        emb = iv.emb_perm
        qs = query_span(q, emb.dtype).repeat_interleave(P, dim=0).contiguous()
        err = compare_k4(f"{name} G={G} W={W}", emb, qs, starts, W)
        k4_err = max(k4_err, err)
        ms = cuda_ms(lambda: probe_span_scores(emb, qs, starts, window=W), flush)
        pms = cuda_ms(lambda: probe_span_scores_plain(emb, qs, starts, window=W), flush)
        D = emb.shape[1]
        # each distinct row the spans touch read once, the queries and
        # starts read once, the [G, W] scores written; G x W x D products
        bnd = bound(touched * D * emb.element_size() + G * D * qs.element_size()
                    + 4 * G + 4 * G * W,
                    2 * G * W * D, INT8_OPS_S if emb.dtype == torch.int8 else F32_OPS_S)
        lib = None
        if emb.dtype == torch.float32:
            # yardstick: the spans gathered by one index, then torch.bmm
            lib = library_time("K4", lambda: torch.bmm(emb[pos], qs[:, :, None]), flush,
                               reps=5)
        gbs = G * W * D * emb.element_size() / ms / 1e6
        out[name] = dict(G=G, W=W, err=err, ms=ms, plain_ms=pms, gb_s=gbs,
                         bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib)
        log(f"K4 {name} G={G} W={W} D={D}: max|diff| {err:.3g}  kernel {share(ms, bnd)} "
            f"({gbs:.0f} GB/s)  plain {pms:.4f} ms"
            + (f"  gather + bmm {lib if lib is None else f'{lib:.4f}'} ms"
               if emb.dtype == torch.float32 else ""))
        # edge cases on the same store: G = 1, W off the 32/128 grid,
        # spans running past the last row, unaligned starts
        n = emb.shape[0]
        edge = {
            "G=1": (qs[:1].contiguous(), starts[:1].contiguous(), W),
            "W=77": (qs, starts, 77),
            "past the end": (qs[:8].contiguous(),
                             torch.arange(n - 8, n, dtype=torch.int32, device=dev), W),
            "unaligned": (qs, (starts + torch.randint(1, 31, starts.shape, generator=gen,
                                                       device=dev, dtype=torch.int32)),
                          W),
        }
        for ename, (eq, es, ew) in edge.items():
            k4_err = max(k4_err, compare_k4(f"{name} {ename}", emb, eq, es, ew))
    # D = 1000: int8 rows of 1000 bytes take the element path
    base = unit_rows(5000, 1000, gen, dev)
    qd = unit_rows(33, 1000, gen, dev)
    sd = torch.randint(-5, 5005, (33,), generator=gen, device=dev, dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        emb = query_span(base, dt)
        k4_err = max(k4_err, compare_k4(f"D=1000 {dt}", emb, query_span(qd, dt), sd, 77))
    log(f"K4 edge cases (G=1, W=77, past the end, unaligned, D=1000) agree; "
        f"max|diff| over all cases {k4_err:.3g}")

    # K2 on the IVF arrays: row ids with zero scales, and with int8 row scales
    f32, i8 = stores["float32"], stores["int8"]
    for ids, sc in ((f32.row_ids, f32.zero_scales(f32.row_ids.shape[0])),
                    (i8.row_ids, i8.row_scale)):
        got = gather_posting_spans(ids, sc, starts, window=W)
        ref = gather_posting_spans_plain(ids, sc, starts, window=W)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              "K2 on the IVF arrays: not bitwise equal to plain")
    out["k2"] = k2_shape("IVF arm, row_ids + int8 row_scale, nprobe 8",
                         [i8.row_ids, i8.row_scale], [starts], W, flush)
    out["k4_err"] = k4_err
    return out


def _wrappers():
    from rag_challenge_2_tpu_torch.ops.dense_topk import dense_topk_fused
    from rag_challenge_2_tpu_torch.ops.probe_scores import probe_span_scores
    from rag_challenge_2_tpu_torch.ops.span_gather import gather_posting_spans
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk

    return {"dense_topk": dense_topk_fused, "span_gather": gather_posting_spans,
            "probe_scores": probe_span_scores, "stream_topk": stream_topk}


def zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0
    k3 = _wrappers()["stream_topk"]
    for r in k3.regime_launches:
        k3.regime_launches[r] = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def k3_regimes():
    """K3's launches by regime since the last :func:`zero_counts`."""
    return dict(_wrappers()["stream_topk"].regime_launches)


def phase5c_engine(dev, ctx3):
    """The engine's use_ivf arm on phase 3's corpus, held against the same
    engine on a CPU copy of the index and of the same IVFIndex: row-range
    routing, then doc-equality routing after cluster_order()."""
    from rag_challenge_2_tpu_torch.retrieval import QueryEngine, SearchConfig

    eng = ctx3["eng"]
    ivf, t_build = wall(lambda: eng.build_ivf(), dev)
    log(f"deployment IVF: built on the card in {t_build:.2f} s, K {ivf.k_clusters}, "
        f"max_list {ivf.max_list}")
    cpu_eng = QueryEngine(eng.index.to("cpu"), eng.meta, ivf=ivf.to("cpu"))
    cfg = SearchConfig(method="basic", top_k=30, top_n=30, use_bm25=True,
                       bm25_top_k=30, use_ivf=True)
    out = {}
    for mode in ("win_start", "pair_doc"):
        if mode == "pair_doc":
            eng, cpu_eng = eng.cluster_order(), cpu_eng.cluster_order()
            check(eng.window == 0 and eng.ivf.cluster_doc is not None,
                  "cluster order: doc-equality routing expected")
        else:
            check(eng.window > 0 and eng.ivf.list_row_min is not None,
                  "windowed corpus: row-range routing expected")

        def run_all():
            return [eng.search(qe, COMPANY, question, years, cfg, query_texts=qtexts)
                    for question, qtexts, years, qe in ctx3["requests"]]

        run_all()                                   # warm-up
        zero_counts()
        cands, t = wall(run_all, dev)
        launches = read_counts()
        log(f"IVF arm ({mode}) launches: {launches}")
        check(launches["probe_scores"] > 0 and launches["span_gather"] > 0,
              f"IVF arm ({mode}): K4 or K2 never launched: {launches}")
        check(launches["dense_topk"] == 0, f"IVF arm ({mode}) ran the dense arm")
        reordered = 0
        for (question, qtexts, years, qe), c in zip(ctx3["requests"], cands):
            ref = cpu_eng.search(qe.cpu(), COMPANY, question, years, cfg,
                                 query_texts=qtexts)
            check(bool((c.key >= 0).any()), f"IVF arm ({mode}): no hits")
            reordered += same_candidates(c, ref, 1e-4)
        nq = sum(len(r[1]) for r in ctx3["requests"])
        log(f"IVF arm ({mode}): GPU engine == CPU plain engine on all "
            f"{len(cands)} requests (tie groups reordered: {reordered}); "
            f"{nq} queries in {t * 1e3:.1f} ms = {nq / t:.1f} queries/s")
        out[mode] = dict(launches=launches, qps=nq / t, reordered_ties=reordered)
    return out


def phase5_ivf(dev, seed, ctx3, N=1_000_000, D=1024, K=4096):
    import dataclasses

    import numpy as np
    import torch

    from rag_challenge_2_tpu_torch.index.ivf import (
        build_ivf, ivf_search, quantize_ivf, select_probes)
    from rag_challenge_2_tpu_torch.index.schema import CorpusIndex
    from rag_challenge_2_tpu_torch.ops.dense_topk import dense_topk_fused
    from rag_challenge_2_tpu_torch.ops.probe_scores import probe_span_scores
    from rag_challenge_2_tpu_torch.ops.span_gather import gather_posting_spans
    from rag_challenge_2_tpu_torch.retrieval import Request, SearchConfig, search_device
    from rag_challenge_2_tpu_torch.retrieval.engine import fuse_blocks, ivf_hits

    log(f"== phase 5: IVF probe path ({N} x {D}, K={K}: BASELINE config 3)")
    # the phase's own generator: its data do not depend on what the
    # earlier phases drew
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    emb, q = ivf_data(dev, gen, N, D)
    NQ = q.shape[0]
    ivf, t_build = wall(lambda: build_ivf(
        emb, n_clusters=K, iters=8, max_list_size=max(2 * N // K, 16)), dev)
    log(f"IVF build on the card (k-means K={K}, 8 iters, balanced, seed 0): "
        f"{t_build:.2f} s, K {ivf.k_clusters}, max_list {ivf.max_list}, "
        f"n_pad {ivf.emb_perm.shape[0]}")
    oracle_k1 = [dense_topk_fused(q[s:s + 64].contiguous(), emb, 30)
                 for s in range(0, NQ, 64)]
    oracle_v = torch.cat([v for v, _ in oracle_k1])
    oracle_i = torch.cat([i for _, i in oracle_k1])
    oracle = oracle_i.cpu().numpy()
    stores = {"float32": ivf,
              "bfloat16": dataclasses.replace(ivf, emb_perm=ivf.emb_perm.to(torch.bfloat16)),
              "int8": quantize_ivf(ivf)}

    # 5a: the kernels at the real probe shape (nprobe 8)
    probes = select_probes(ivf, q, 8)
    starts = ivf.list_offsets[probes].reshape(-1).contiguous()
    k = phase5a_kernels(dev, gen, flush, stores, q, starts, ivf.max_list)

    # 5b: recall and queries/s of ivf_search against the exact oracle
    def qps_of(iv, nprobe):
        ts = []
        for _ in range(10):
            _, t = wall(lambda: ivf_search(iv, q, 30, nprobe=nprobe), dev)
            ts.append(t)
        return NQ / statistics.median(ts)

    sweep = {}
    zero_counts()
    for name, nps in (("float32", (2, 4, 8)), ("bfloat16", (4, 8)), ("int8", (4, 8))):
        for nprobe in nps:
            got = ivf_search(stores[name], q, 30, nprobe=nprobe)[1].cpu().numpy()
            r10, r30 = recall_at(got, oracle, 10), recall_at(got, oracle, 30)
            qps = qps_of(stores[name], nprobe)
            sweep[f"{name}_np{nprobe}"] = dict(recall10=r10, recall30=r30, qps=qps)
            log(f"IVF-1M {name} nprobe={nprobe}: recall@10 {r10:.4f} recall@30 "
                f"{r30:.4f}  {qps:.1f} queries/s (127 per call)")
    launches = read_counts()
    check(launches["probe_scores"] > 0 and launches["span_gather"] > 0,
          f"ivf_search never launched K4 / K2: {launches}")
    low = [n for n in ("float32_np2", "float32_np4")
           if sweep[n]["recall30"] < sweep[n]["recall10"]]
    log(f"recall@30 < recall@10 at low nprobe (the reference's r5 tail): "
        f"{'reproduces at ' + ', '.join(low) if low else 'does not reproduce'}")
    check(sweep["float32_np8"]["recall10"] >= 0.99,
          f"IVF-1M f32 recall@10 at nprobe 8 {sweep['float32_np8']['recall10']} < 0.99")
    check(sweep["float32_np4"]["recall10"] >= 0.90,
          f"IVF-1M f32 recall@10 at nprobe 4 {sweep['float32_np4']['recall10']} < 0.90")
    del stores, flush
    torch.cuda.empty_cache()

    # 5c: the engine's use_ivf arm, at the deployment size, then at 1M
    eng_out = phase5c_engine(dev, ctx3)
    N_DOCS, Q_BATCH, REPS = 6, 8, 16
    per_doc = N // N_DOCS
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    doc_id = (rows // per_doc).clamp(max=N_DOCS - 1)
    idx = CorpusIndex(
        emb=emb, doc_id=doc_id, page=rows % 500 + 1, year=2020 + doc_id,
        company_id=torch.zeros_like(rows), kind=torch.zeros_like(rows),
        page_seg=rows // 4, chunk_in_doc=rows - doc_id * per_doc,
        valid=torch.ones(N, dtype=torch.bool, device=dev), sparse=None,
        n_chunks=N, n_pages=N // 4, n_docs=N_DOCS, dim=D)
    ws = np.arange(N_DOCS, dtype=np.int32) * per_doc
    wl = np.diff(np.append(ws, N)).astype(np.int32)
    window = -(-int(wl.max()) // 128) * 128
    cfg = SearchConfig(method="basic", top_k=30, max_queries=Q_BATCH,
                       max_docs=N_DOCS, top_n=30, use_ivf=True, ivf_nprobe=8)
    q_valid = torch.ones(Q_BATCH, dtype=torch.bool, device=dev)
    doc_masks = torch.stack([doc_id == d for d in range(N_DOCS)])
    doc_valid = np.array([True, True, True, False, False, False])
    row_slot = torch.where(doc_id < 3, doc_id, N_DOCS).to(torch.int32)
    reqs = [Request(q[(r * Q_BATCH) % (NQ - Q_BATCH):][:Q_BATCH].contiguous(),
                    q_valid, doc_masks, doc_valid, None, row_slot, ws, wl)
            for r in range(REPS)]

    def calls():
        return [search_device(idx, rq, cfg, window=window, ivf=ivf)[0] for rq in reqs]

    calls()                                               # warm-up
    runs = []
    for _ in range(3):
        fused, t = wall(calls, dev)
        runs.append(t)
    t = statistics.median(runs)
    qps = Q_BATCH * REPS / t
    for f in fused:
        keys = f.key[f.key >= 0]
        check(keys.numel() > 0 and bool((keys < 3 * per_doc).all()),
              "IVF at 1M: hits outside the 3 routed docs")
        check(bool(torch.isfinite(f.score).all()), "IVF at 1M: non-finite scores")
    # per-stage split of the same calls, synchronised after each stage
    stages = dict(coarse=0.0, k4=0.0, k2=0.0, ivf_hits=0.0, fuse=0.0)
    M = N_DOCS
    P = 8
    W = ivf.max_list
    for rq in reqs:
        qp = rq.q.repeat_interleave(M, dim=0)
        pw_s = torch.as_tensor(ws, device=dev).repeat(Q_BATCH)
        pw_l = torch.as_tensor(np.where(doc_valid, wl, 0), device=dev).repeat(Q_BATCH)
        pr, t1 = wall(lambda: select_probes(ivf, qp, P, win_start=pw_s, win_len=pw_l), dev)
        st = ivf.list_offsets[pr].reshape(-1).contiguous()
        qs = qp.repeat_interleave(P, dim=0).contiguous()
        _, t2 = wall(lambda: probe_span_scores(ivf.emb_perm, qs, st, window=W), dev)
        _, t3 = wall(lambda: gather_posting_spans(
            ivf.row_ids, ivf.zero_scales(ivf.row_ids.shape[0]), st, window=W), dev)
        blk, t4 = wall(lambda: ivf_hits(idx, ivf, rq, cfg, window), dev)
        _, t5 = wall(lambda: fuse_blocks(idx, [blk], cfg), dev)
        for name, v in zip(stages, (t1, t2, t3, t4, t5)):
            stages[name] += v
    per_call = {k_: v / REPS * 1e3 for k_, v in stages.items()}
    per_call["rest_of_ivf_hits"] = per_call["ivf_hits"] - (
        per_call["coarse"] + per_call["k4"] + per_call["k2"])
    log(f"IVF engine at 1M (6 docs, 3 routed, {REPS} calls x {Q_BATCH} queries, "
        f"nprobe 8, W {W}): median of 3 windows {t * 1e3:.2f} ms = {qps:.1f} queries/s "
        f"(runs {', '.join(f'{r * 1e3:.2f}' for r in runs)} ms)")
    log("IVF engine at 1M per-stage ms/call: "
        + ", ".join(f"{k_} {v:.3f}" for k_, v in per_call.items()))
    # phase 6a holds K3 against plain on the same 1M store and queries,
    # and its rows against this K1 oracle
    ctx5 = dict(emb=emb, q=q, oracle_v=oracle_v, oracle_i=oracle_i)
    return dict(build_s=t_build, k_clusters=ivf.k_clusters, max_list=ivf.max_list,
                sweep=sweep, kernels=k, engine=eng_out, engine_1m_qps=qps,
                engine_1m_window_ms=[r * 1e3 for r in runs],
                engine_1m_stage_ms=per_call), ctx5


# --------------------------------------------------------------- phase 6

def compare_k3(name, q, emb, k, mask=None, exact=False, **kw):
    """K3 against its plain version on the same operands: int8 forms
    bitwise (values and rows), f32 / bf16 values within 1e-4 and rows
    equal where untied.  Returns ``(max abs diff, kernel values, rows)``."""
    import torch

    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk, stream_topk_plain

    kv, ki = stream_topk(q, emb, k, mask, **kw)
    pv, pi = stream_topk_plain(q, emb, k, mask, **kw)
    torch.cuda.synchronize()
    check(kv.shape == pv.shape, f"K3 {name}: shape {kv.shape} vs {pv.shape}")
    err = (kv - pv).abs().max().item()
    if exact:
        check(torch.equal(kv, pv) and torch.equal(ki, pi),
              f"K3 {name}: not bitwise equal to plain (max |diff| {err})")
    else:
        check(err <= K1_TOL, f"K3 {name}: max abs diff {err} > {K1_TOL}")
        u = untied(pv, K1_TOL)
        check(torch.equal(ki[u], pi[u]), f"K3 {name}: untied rows differ")
    return err, kv, ki


def phase6a_1m(dev, flush, ctx5):
    """K3 against plain on phase 5's 1M x 1024 store with its 127 queries
    (f32 and bf16, k = 30), the f32 rows against phase 5's K1 oracle, and
    the edge cases."""
    import torch

    from rag_challenge_2_tpu_torch.ops.quant import quantize_rows
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk, stream_topk_plain

    emb, q = ctx5["emb"], ctx5["q"]
    N, D = emb.shape
    out, err_max = {}, 0.0
    for dt in (torch.float32, torch.bfloat16):
        e = emb if dt == torch.float32 else emb.to(dt)
        err, kv, ki = compare_k3(f"N={N} {dt}", q, e, 30)
        err_max = max(err_max, err)
        if dt == torch.float32:
            u = untied(ctx5["oracle_v"], K1_TOL)
            check(torch.equal(ki[u], ctx5["oracle_i"][u]),
                  "K3 f32 rows differ from phase 5's K1 oracle")
            check((kv - ctx5["oracle_v"]).abs().max().item() <= K1_TOL,
                  "K3 f32 values differ from phase 5's K1 oracle")
        ms = cuda_ms(lambda: stream_topk(q, e, 30), flush, reps=10)
        pms = cuda_ms(lambda: stream_topk_plain(q, e, 30), flush, reps=10)
        name = str(dt).split(".")[1]
        bnd = k3_bound(N, D, e.element_size(), q.shape[0], q.shape[0], 30, F32_OPS_S, 0)
        # yardstick: one matmul in the store's type (TF32 off), then topk
        lib = library_time("K3", lambda: torch.topk(
            torch.matmul(q.to(dt), e.T).float(), 30, dim=1), flush, reps=5)
        out[name] = dict(N=N, B=q.shape[0], k=30, err=err, ms=ms, plain_ms=pms,
                         bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib)
        log(f"K3 {name} B={q.shape[0]} N={N} D={D} k=30: max|diff| {err:.3g}  "
            f"kernel {share(ms, bnd)}  plain {pms:.3f} ms  "
            f"matmul + topk {lib if lib is None else f'{lib:.3f}'} ms")
        # by batch, across the query tiles' edges: each held against plain
        by_batch = {}
        q128 = torch.cat([q, q[:1]]).contiguous()
        for Bq in (8, 64, 65, 96, 128):
            qb = q128[:Bq].contiguous()
            zero_counts()
            err_b, _, _ = compare_k3(f"N={N} {name} B={Bq}", qb, e, 30)
            check(k3_regimes()["float"] == 1,
                  f"K3 {name} B={Bq}: one launch of the float regime: {k3_regimes()}")
            err_max = max(err_max, err_b)
            ms_b = cuda_ms(lambda: stream_topk(qb, e, 30), flush, reps=7)
            bnd_b = k3_bound(N, D, e.element_size(), Bq, Bq, 30, F32_OPS_S, 0)
            by_batch[f"B={Bq}"] = dict(ms=ms_b, bound_ms=bnd_b[0], bound_by=bnd_b[1],
                                       err=err_b)
            log(f"K3 {name} by batch N={N} B={Bq}: max|diff| {err_b:.3g}  "
                f"kernel {share(ms_b, bnd_b)}")
        by_batch[f"B={q.shape[0]}"] = dict(ms=ms, bound_ms=bnd[0], bound_by=bnd[1], err=err)
        out[name]["by_batch"] = by_batch
    log("K3 f32 rows == phase 5's K1 oracle wherever untied")

    # edge cases on slices of the same store, f32 and int8
    e8, sc = quantize_rows(emb[:200_000])
    f32 = emb[:200_000]
    few = torch.zeros(200_000, dtype=torch.bool, device=dev)
    few[torch.tensor([3, 70_000, 199_999], device=dev)] = True
    q128 = torch.cat([q, q[:1]]).contiguous()
    qi8, qsc = quantize_rows(q)
    qi8_128, qsc_128 = quantize_rows(q128)
    ties = emb[:700].repeat(3, 1).contiguous()
    cases = {
        "k=30 > 3 eligible rows": (q, f32, dict(mask=few)),
        "all masked": (q, f32, dict(mask=torch.zeros_like(few))),
        "ties 3x700": (q, ties, {}),
        "B=1": (q[:1].contiguous(), f32, {}),
        "B=128": (q128, f32, {}),
        "int8 k=30 > 3 eligible rows": (qi8, e8, dict(mask=few, q_scale=qsc, row_scale=sc)),
        "int8 all masked": (qi8, e8, dict(mask=torch.zeros_like(few), q_scale=qsc,
                                          row_scale=sc)),
        "int8 B=1": (qi8[:1].contiguous(), e8, dict(q_scale=qsc[:1].contiguous(),
                                                    row_scale=sc)),
        "int8 B=128": (qi8_128, e8, dict(q_scale=qsc_128, row_scale=sc)),
    }
    for name, (qq, e, kw) in cases.items():
        mask = kw.pop("mask", None)
        err, kv, ki = compare_k3(name, qq, e, 30, mask, exact=e.dtype == torch.int8, **kw)
        err_max = max(err_max, err)
        if "eligible" in name:
            check(bool((ki[:, 3:] == -1).all()) and bool((kv[:, 3:] == -3.0e38).all()),
                  f"K3 {name}: slots past the eligible rows must be (-1, NEG_INF)")
        if "all masked" in name:
            check(bool((ki == -1).all()), f"K3 {name}: rows must all be -1")
        if name.startswith("ties"):
            same = kv[:, 1:] == kv[:, :-1]
            check(bool(same.any()) and bool((ki[:, 1:][same] > ki[:, :-1][same]).all()),
                  "K3 ties: equal values must come in ascending row order")
    log(f"K3 edge cases ({', '.join(cases)}) agree with plain; "
        f"max|diff| over all f32/bf16 cases {err_max:.3g}")
    out["err"] = err_max
    return out


def make_10m(dev, seed, N=10_000_000, D=1024, C=500_000, K_CODE=16_384):
    """BASELINE config 5's data on the card (``bench.py`` 326-681): 10M
    unit rows = one of 4,096 unit centres + (0.35/sqrt D) noise, made in
    500k chunks from the phase's own generator; 127 queries = rows of the
    first chunk + (0.25/sqrt D) noise.  Each chunk's f32 top-10 (the plain
    version) merges into the oracle before the chunk is quantized into a
    plain int8 store and a centroid-residual store (codebook: k-means
    K = 16,384 on a 250k sample, 6 iterations)."""
    import torch

    from rag_challenge_2_tpu_torch.ops.kmeans import kmeans
    from rag_challenge_2_tpu_torch.ops.quant import quantize_rows, quantize_rows_residual
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk_plain

    NQ, N_CENTERS = 127, 4096
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    centers = unit_rows(N_CENTERS, D, gen, dev)

    def chunk():
        a = torch.randint(0, N_CENTERS, (C,), generator=gen, device=dev)
        e = centers[a] + (0.35 / D ** 0.5) * torch.randn(C, D, generator=gen, device=dev)
        return e / e.norm(dim=1, keepdim=True)

    t0 = time.perf_counter()
    e = chunk()
    r = torch.randint(0, C, (NQ,), generator=gen, device=dev)
    q = e[r] + (0.25 / D ** 0.5) * torch.randn(NQ, D, generator=gen, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    code, _ = kmeans(e[:250_000], K_CODE, iters=6, seed=0)
    torch.cuda.synchronize()
    t_code = time.perf_counter() - t0
    buf = torch.empty((N, D), dtype=torch.int8, device=dev)
    scales = torch.empty(N, device=dev)
    rbuf = torch.empty((N, D), dtype=torch.int8, device=dev)
    rscales = torch.empty(N, device=dev)
    rassign = torch.empty(N, dtype=torch.int32, device=dev)
    top_v = torch.full((NQ, 10), -3.0e38, device=dev)
    top_i = torch.full((NQ, 10), -1, dtype=torch.int64, device=dev)
    for i in range(N // C):
        if i:
            e = chunk()
        sl = slice(i * C, (i + 1) * C)
        v, j = stream_topk_plain(q, e, 10, block=C)
        cv = torch.cat([top_v, v], 1)
        ci = torch.cat([top_i, j.long() + i * C], 1)
        top_v, nj = torch.sort(cv, dim=1, descending=True, stable=True)
        top_v = top_v[:, :10]
        top_i = torch.gather(ci, 1, nj[:, :10])
        buf[sl], scales[sl] = quantize_rows(e)
        rbuf[sl], rscales[sl], rassign[sl] = quantize_rows_residual(e, code)
    del e
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    log(f"10M data: {N} x {D} unit rows made on the card in {C // 1000}k chunks; "
        f"codebook k-means K={K_CODE} on 250k rows, 6 iters: {t_code:.2f} s; "
        f"oracle + plain int8 + residual stores: {t_all:.2f} s in all; "
        f"stores {2 * N * D / 1e9:.1f} GB")
    return dict(q=q, oracle=top_i.cpu().numpy(), buf=buf, scales=scales, rbuf=rbuf,
                rscales=rscales, rassign=rassign, code=code, N=N, D=D)


def k3_int8_library(q8, qs, emb, rs, k, flush, block=2_500_000):
    """K3 int8's yardstick: ``torch._int_mm`` then ``torch.topk`` on the
    dequantised scores, in row blocks (the full [B, N] int32 product of a
    10M store would not fit beside it), then a top-k of the blocks'."""
    import torch

    def run():
        vals, rows = [], []
        for s0 in range(0, emb.shape[0], block):
            acc = torch._int_mm(q8, emb[s0:s0 + block].T)
            v, i = torch.topk(acc.float() * qs[:, None] * rs[None, s0:s0 + block], k, dim=1)
            vals.append(v)
            rows.append(i + s0)
        v, j = torch.topk(torch.cat(vals, 1), k, dim=1)
        return v, torch.gather(torch.cat(rows, 1), 1, j)

    return library_time("K3", run, flush, reps=3, warmup=1)


def phase6a_10m(dev, flush, data):
    """K3 against plain at 10M for the int8 forms: bitwise, in the large
    regime.  Then K3's residual forms on one hybrid slot's rows by batch,
    across the small / large boundary, while the residual store exists."""
    from rag_challenge_2_tpu_torch.ops.quant import quantize_query_2pass, quantize_rows
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk, stream_topk_plain

    q, N = data["q"], data["N"]
    q8, qs = quantize_rows(q)
    q2, s_hi, s_lo = quantize_query_2pass(q)
    qc = (q @ data["code"].T).contiguous()
    forms = {
        "int8": (q8, data["buf"], dict(q_scale=qs, row_scale=data["scales"])),
        "int8 2-pass": (q2, data["buf"], dict(q_scale=s_hi, q_scale_lo=s_lo,
                                              row_scale=data["scales"])),
        "residual 2-pass": (q2, data["rbuf"], dict(
            q_scale=s_hi, q_scale_lo=s_lo, row_scale=data["rscales"],
            assign=data["rassign"], qc=qc)),
    }
    out = {}
    B, D = q.shape[0], data["D"]
    for name, (qq, e, kw) in forms.items():
        zero_counts()
        compare_k3(f"{name} N={N}", qq, e, 30, exact=True, **kw)
        check(k3_regimes()["int8_large"] == 1,
              f"K3 {name} at B={B}: the large regime must run: {k3_regimes()}")
        ms = cuda_ms(lambda: stream_topk(qq, e, 30, **kw), flush, reps=5, warmup=1)
        pms = cuda_ms(lambda: stream_topk_plain(qq, e, 30, **kw), flush, reps=3, warmup=1)
        rows_q = qq.shape[0]
        ops = 2 * rows_q * N * D
        bnd = k3_bound(N, D, 1, rows_q, B, 30, INT8_OPS_S, 2 if "residual" in name else 1)
        out[name] = dict(N=N, B=B, k=30, ms=ms, plain_ms=pms, tops=ops / ms / 1e9,
                         bound_ms=bnd[0], bound_by=bnd[1])
        log(f"K3 {name} B={B} N={N} k=30: bitwise equal to plain  kernel {share(ms, bnd)} "
            f"({ops / ms / 1e9:.1f} int8 TOP/s)  plain {pms:.2f} ms")
    lib = k3_int8_library(q8, qs, data["buf"], data["scales"], 30, flush)
    out["int8"]["library_ms"] = lib
    log(f"K3 int8 yardstick at N={N}: torch._int_mm + torch.topk "
        f"{lib if lib is None else f'{lib:.2f}'} ms")

    # the residual forms on the rows of one routed slot of the 10M hybrid
    slot = N // 6
    e, rs, ra = data["rbuf"][:slot], data["rscales"][:slot], data["rassign"][:slot]
    by_batch = {}
    for two in (False, True):
        for b in (4, 8, 9):
            qb = q[:b].contiguous()
            if two:
                qq, s_hi, s_lo = quantize_query_2pass(qb)
                kw = dict(q_scale=s_hi, q_scale_lo=s_lo)
            else:
                qq, qs_b = quantize_rows(qb)
                kw = dict(q_scale=qs_b)
            kw.update(row_scale=rs, assign=ra, qc=(qb @ data["code"].T).contiguous())
            name = f"residual {'2-pass' if two else '1-pass'} B={b}"
            zero_counts()
            compare_k3(f"{name} N={slot}", qq, e, 30, exact=True, **kw)
            regime = "int8_small" if qq.shape[0] <= 16 else "int8_large"
            check(k3_regimes()[regime] == 1, f"K3 {name}: {regime} expected: {k3_regimes()}")
            ms = cuda_ms(lambda: stream_topk(qq, e, 30, **kw), flush, reps=10)
            bnd = k3_bound(slot, D, 1, qq.shape[0], b, 30, INT8_OPS_S, 2)
            by_batch[name] = dict(ms=ms, regime=regime, bound_ms=bnd[0])
            log(f"K3 {name} N={slot} ({regime}): bitwise equal to plain  "
                f"kernel {share(ms, bnd)}")
    out["residual_slot_by_batch"] = by_batch
    return out


def phase6b_scans(dev, data):
    """Recall@10 against the f32 oracle and queries/s (127 per call) of
    the four scan arms, with the gates."""
    import torch

    from rag_challenge_2_tpu_torch.ops.quant import (
        int8_residual_topk, int8_residual_topk_rescored, int8_topk)
    from rag_challenge_2_tpu_torch.ops.topk import approx_topk

    q, buf, sc = data["q"], data["buf"], data["scales"]
    rb, rs, ra, code = data["rbuf"], data["rscales"], data["rassign"], data["code"]
    arms = {
        "int8_topk": lambda: int8_topk(q, buf, sc, 10),
        "approx_topk": lambda: approx_topk(q, buf, 10, recall_target=0.95, row_scale=sc),
        "residual_2pass": lambda: int8_residual_topk(q, rb, rs, ra, code, 10,
                                                     query_2pass=True),
        "rescored": lambda: int8_residual_topk_rescored(q, rb, rs, ra, code, 10,
                                                        k_cand=48, recall_target=0.95),
    }
    for fn in arms.values():                              # warm-up
        fn()
    zero_counts()
    out = {}
    for name, fn in arms.items():
        runs = []
        for _ in range(3):
            (v, i), t = wall(fn, dev)
            runs.append(t)
        check(bool(torch.isfinite(v).all()), f"10M {name}: non-finite scores")
        r10 = recall_at(i.cpu().numpy(), data["oracle"], 10)
        t = statistics.median(runs)
        out[name] = dict(recall10=r10, qps=q.shape[0] / t, ms=t * 1e3)
        log(f"10M {name}: recall@10 {r10:.4f} vs the f32 oracle, "
            f"{q.shape[0] / t:.1f} queries/s ({t * 1e3:.2f} ms per 127 queries)")
    launches = read_counts()
    log(f"10M scan launches: {launches}")
    check(launches["stream_topk"] > 0, f"the 10M scans never launched K3: {launches}")
    plain, resc = out["int8_topk"]["recall10"], out["rescored"]["recall10"]
    check(plain >= 0.89, f"10M plain int8 recall@10 {plain} < 0.89")
    check(resc >= 0.94, f"10M rescored recall@10 {resc} < 0.94")
    check(resc > plain, f"10M rescored recall@10 {resc} <= plain int8 {plain}")
    check(out["approx_topk"]["recall10"] == plain, "approx_topk must equal the exact scan")
    return dict(arms=out, launches=launches)


def profile_hybrid10m(dev, idx, hreqs, cfg, window, data):
    """K3's time on one routed slot against the batch size, the hybrid's
    per-stage split (host clock around each stage), and the device's busy
    share over one window of calls (``torch.profiler``: summed device
    kernel time over wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rag_challenge_2_tpu_torch.ops.quant import quantize_query_2pass, quantize_rows
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk
    from rag_challenge_2_tpu_torch.retrieval.engine import (
        bm25_hits, dense_hits, fuse_blocks, search_device)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    e, r = data["buf"][:window], data["scales"][:window]
    D = data["D"]
    q = torch.cat([data["q"], data["q"][:1]])            # 128 queries
    by_batch = {}
    for two, batches in ((False, (1, 4, 8, 16, 17, 32, 64, 127, 128)), (True, (4, 8, 9))):
        for B in batches:
            if two:
                qq, s_hi, s_lo = quantize_query_2pass(q[:B].contiguous())
                kw = dict(q_scale=s_hi, q_scale_lo=s_lo)
            else:
                qq, qs = quantize_rows(q[:B].contiguous())
                kw = dict(q_scale=qs)
            ms = cuda_ms(lambda: stream_topk(qq, e, 30, row_scale=r, **kw), flush, reps=10)
            bnd = k3_bound(window, D, 1, qq.shape[0], B, 30, INT8_OPS_S)
            name = f"{'2-pass ' if two else ''}B={B}"
            by_batch[name] = dict(ms=ms, bound_ms=bnd[0],
                                  regime="int8_small" if qq.shape[0] <= 16 else "int8_large")
            log(f"K3 int8 on one slot (N={window}, k=30) {name} ({by_batch[name]['regime']}): "
                f"{share(ms, bnd)}")
    del flush
    stages = dict(dense=0.0, bm25=0.0, fuse=0.0)
    for rq in hreqs:
        bd, t1 = wall(lambda: dense_hits(idx, rq, cfg, window), dev)
        bb, t2 = wall(lambda: bm25_hits(idx, rq, cfg, window), dev)
        _, t3 = wall(lambda: fuse_blocks(idx, [bd, bb], cfg), dev)
        for name, t in zip(stages, (t1, t2, t3)):
            stages[name] += t
    stage_ms = {k: v / len(hreqs) * 1e3 for k, v in stages.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for rq in hreqs:
            search_device(idx, rq, cfg, window=window)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = sorted(prof.key_averages(), key=device_us, reverse=True)
    device_ms = sum(device_us(ev) for ev in evs) / 1e3
    top = {ev.key[:60]: device_us(ev) / 1e3 for ev in evs[:6] if device_us(ev)}
    log("hybrid 10M per-stage ms/call: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()))
    log(f"hybrid 10M profiled window of {len(hreqs)} calls: wall {wall_ms:.2f} ms, "
        f"device kernels {device_ms:.2f} ms = {100 * device_ms / wall_ms:.1f}% busy; top: "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in top.items()))
    return dict(k3_ms_by_batch=by_batch, stage_ms=stage_ms, wall_ms=wall_ms,
                device_ms=device_ms, busy=device_ms / wall_ms, top_ms=top)


def deploy_slots_k3(eng, name, reqs, cfg):
    """K3's f32 / bf16 form as search_many's dense_hits launches it: the 128
    stacked queries (and 96 of them, the other tile of 4 rows per lane)
    against each routed slot of the deployment store.  A slot has fewer
    tiles than the grid has blocks, so a block owns a chunk smaller than a
    tile and a stage brings only its rows: that cut is held against plain
    here (values within 1e-4, rows equal where untied), and dense_topk
    returns K3's result.  Returns the largest difference."""
    import numpy as np
    import torch

    from rag_challenge_2_tpu_torch.ops.float_scan import sm_count
    from rag_challenge_2_tpu_torch.ops.stream_topk import plan
    from rag_challenge_2_tpu_torch.ops.topk import dense_topk

    question, _, years, _ = reqs[0]
    prepared = [eng.prepare(qe, COMPANY, question, years, cfg, query_texts=tx)
                for _, tx, _, qe in reqs]
    rq = prepared[0]
    big = torch.cat([r.q for r in prepared]).contiguous()
    M, N = rq.doc_masks.shape
    k = min(cfg.top_k, N)
    emb = eng.index.emb
    windowed = eng.window > 0 and eng.window >= k and M * eng.window <= 2 * N
    err_max, shapes = 0.0, []
    for m in np.flatnonzero(rq.doc_valid):
        if windowed:
            ws, wl = int(rq.win_start[m]), int(rq.win_len[m])
            e_m, mask = emb[ws:ws + wl], None
        else:
            e_m, mask = emb, rq.doc_masks[m]
        for B in (96, big.shape[0]):
            qb = big[:B].contiguous()
            cut = plan(B, False, False, e_m.shape[0], sm_count(emb.device), k,
                       e_m.element_size()).cut
            check(cut.query_tile == (128 if B > 96 else 96)
                  and cut.box_rows < cut.tile_rows and cut.n_chunks > 1,
                  f"search_many slot {m} ({name}, B={B}): expected chunks smaller than "
                  f"a tile of the {B}-query layout: {cut}")
            zero_counts()
            err, kv, ki = compare_k3(f"search_many slot {m} ({name}, {e_m.shape[0]} rows, "
                                     f"B={B})", qb, e_m, k, mask)
            check(k3_regimes()["float"] == 1,
                  f"search_many slot {m} ({name}): one float launch: {k3_regimes()}")
            err_max = max(err_max, err)
            shapes.append((B, e_m.shape[0], cut.box_rows, cut.n_chunks))
        if mask is None:                    # kv, ki: the full stack's, run last
            dv, di = dense_topk(big, e_m, k)
            check(torch.equal(dv, kv) and torch.equal(di.long(), ki.long()),
                  f"search_many slot {m} ({name}): dense_topk differs from K3")
    log(f"search_many ({name} store): K3 on each routed slot, as dense_hits launches it "
        f"(B, rows, rows per stage, chunks: {shapes[:2]} ...), agrees with plain: "
        f"max|diff| {err_max:.3g}")
    return err_max


def phase6c_engine(dev, gen, ctx3, data):
    """The engine's int8 arm: phase 3's corpus through quantize_index held
    against the CPU engine; search_many of 16 requests against the CPU
    engine's and 16 search calls (f32, bf16 and int8 stores) with K3 on the
    f32 / bf16 slots against plain (:func:`deploy_slots_k3`); the hybrid at 10M
    with scan_rt None and 0.95, K3 on its routed slots against plain, and
    :func:`profile_hybrid10m`."""
    import dataclasses

    import numpy as np
    import torch

    from rag_challenge_2_tpu_torch.index import quantize_index
    from rag_challenge_2_tpu_torch.index.schema import CorpusIndex, SparseIndex
    from rag_challenge_2_tpu_torch.retrieval import (
        QueryEngine, Request, SearchConfig, search_device)

    out = {}
    eng = ctx3["eng"]
    eng8 = QueryEngine(quantize_index(eng.index), eng.meta)
    cpu8 = QueryEngine(eng8.index.to("cpu"), eng.meta)
    cfg = SearchConfig(method="basic", top_k=30, top_n=30, use_bm25=True,
                       bm25_top_k=30)
    reqs = ctx3["requests"]

    def run_all(e):
        return [e.search(qe, COMPANY, question, years, cfg, query_texts=qtexts)
                for question, qtexts, years, qe in reqs]

    run_all(eng8)                                          # warm-up
    zero_counts()
    cands, t = wall(lambda: run_all(eng8), dev)
    launches = read_counts()
    check(launches["stream_topk"] > 0 and launches["dense_topk"] == 0,
          f"int8 engine: the dense arm must run K3 only: {launches}")
    reordered = 0
    for (question, qtexts, years, qe), c in zip(reqs, cands):
        ref = cpu8.search(qe.cpu(), COMPANY, question, years, cfg, query_texts=qtexts)
        reordered += same_candidates(c, ref, 1e-4)
    nq = sum(len(r[1]) for r in reqs)
    log(f"int8 engine (phase 3's corpus through quantize_index) launches {launches}: "
        f"GPU == CPU plain engine on all {len(reqs)} requests (tie groups reordered: "
        f"{reordered}); {nq} queries in {t * 1e3:.1f} ms = {nq / t:.1f} queries/s")
    out["deploy_int8"] = dict(launches=launches, qps=nq / t, reordered_ties=reordered)

    # search_many: 16 requests of one route = 128 stacked queries per slot,
    # held against the CPU engine's search_many (plain versions) and
    # against 16 search calls on the card
    question, _, years, _ = reqs[0]
    qes = [r[3] for r in reqs]
    texts = [r[1] for r in reqs]
    cpu_f = QueryEngine(eng.index.to("cpu"), eng.meta)
    idx_bf = dataclasses.replace(eng.index, emb=eng.index.emb.to(torch.bfloat16))
    eng_bf = QueryEngine(idx_bf, eng.meta)
    cpu_bf = QueryEngine(idx_bf.to("cpu"), eng.meta)
    for name, e, cpu_e in (("float32", eng, cpu_f), ("bfloat16", eng_bf, cpu_bf),
                           ("int8", eng8, cpu8)):
        e.search_many(qes, COMPANY, question, years, cfg, query_texts_list=texts)
        zero_counts()
        many, t_many = wall(lambda: e.search_many(qes, COMPANY, question, years, cfg,
                                                  query_texts_list=texts), dev)
        launches = read_counts()
        regimes = k3_regimes()
        check(launches["stream_topk"] > 0 and launches["dense_topk"] == 0,
              f"search_many ({name}): 128 stacked queries must run K3: {launches}")
        check((name == "int8") != (regimes["float"] == launches["stream_topk"]),
              f"search_many ({name}): K3 ran the wrong regime: {regimes}")
        singles, t_one = wall(lambda: [
            e.search(qe, COMPANY, question, years, cfg, query_texts=tx)
            for qe, tx in zip(qes, texts)], dev)
        ref = cpu_e.search_many([qe.cpu() for qe in qes], COMPANY, question, years, cfg,
                                query_texts_list=texts)
        reordered = sum(same_candidates(a, b, 1e-4) for a, b in zip(many, ref))
        reordered += sum(same_candidates(a, b, 1e-4) for a, b in zip(many, singles))
        log(f"search_many ({name} store) of {len(qes)} requests == the CPU engine's "
            f"search_many == {len(qes)} search calls "
            f"(tie groups reordered: {reordered}); launches {launches}; "
            f"{nq / t_many:.1f} vs {nq / t_one:.1f} queries/s")
        out[f"search_many_{name}"] = dict(launches=launches, qps=nq / t_many,
                                          qps_separate=nq / t_one)
        if name != "int8":
            out[f"search_many_{name}"]["slot_err"] = deploy_slots_k3(e, name, reqs, cfg)
    del eng_bf, cpu_bf, idx_bf

    # the hybrid at 10M (bench.py:433-477): 6 docs, 3 routed, Q = 4
    N = data["N"]
    N_DOCS, Q_BATCH, T, REPS = 6, 4, 64, 16
    csr = make_csr(dev, gen, N)
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    per_doc = N // N_DOCS
    doc_id = (rows // per_doc).clamp(max=N_DOCS - 1)
    sparse = SparseIndex(
        indptr=csr["indptr"], chunk_ids=csr["chunk_ids"], tf=csr["tf"],
        df=csr["df"], chunk_len=csr["chunk_len"], avgdl=csr["chunk_len"].mean(),
        dl=csr["dl"], vocab_bits=18, max_postings=csr["W"], dma_pad=csr["dma_pad"])
    idx = CorpusIndex(
        emb=data["buf"], doc_id=doc_id, page=rows % 500 + 1, year=2020 + doc_id,
        company_id=torch.zeros_like(rows), kind=torch.zeros_like(rows),
        page_seg=rows // 4, chunk_in_doc=rows - doc_id * per_doc,
        valid=torch.ones(N, dtype=torch.bool, device=dev), sparse=sparse,
        emb_scale=data["scales"], n_chunks=N, n_pages=N // 4, n_docs=N_DOCS,
        dim=data["D"])
    doc_masks = torch.stack([doc_id == d for d in range(N_DOCS)])
    doc_valid = np.array([True, True, True, False, False, False])
    row_slot = torch.where(doc_id < 3, doc_id, N_DOCS).to(torch.int32)
    ws = np.arange(N_DOCS, dtype=np.int32) * per_doc
    wl = np.diff(np.append(ws, N)).astype(np.int32)
    q = data["q"]
    NQ = q.shape[0]
    q_valid = torch.ones(Q_BATCH, dtype=torch.bool, device=dev)
    q_terms = torch.randint(0, csr["V"], (Q_BATCH, T), generator=gen, device=dev,
                            dtype=torch.int32)
    hreqs = [Request(q[(r * Q_BATCH) % (NQ - Q_BATCH):][:Q_BATCH].contiguous(),
                     q_valid, doc_masks, doc_valid, q_terms, row_slot, ws, wl)
             for r in range(REPS)]
    fused_of = {}
    for rt in (None, 0.95):
        c = SearchConfig(method="basic", top_k=30, max_queries=Q_BATCH,
                         max_docs=N_DOCS, top_n=30, use_bm25=True, bm25_top_k=30,
                         scan_rt=rt)

        def window():
            return [search_device(idx, rq, c, window=per_doc)[0] for rq in hreqs]

        window()                                           # warm-up
        zero_counts()
        runs = []
        for _ in range(3):
            fused, t = wall(window, dev)
            runs.append(t)
        launches = read_counts()
        regimes = k3_regimes()
        check(launches["stream_topk"] > 0 and launches["span_gather"] > 0,
              f"hybrid 10M (scan_rt={rt}): K3 or K2 never launched: {launches}")
        check(regimes["int8_small"] == launches["stream_topk"],
              f"hybrid 10M (scan_rt={rt}): the Q = {Q_BATCH} slots must run K3's small "
              f"regime: {regimes}")
        for f in fused:
            keys = f.key[f.key >= 0]
            check(keys.numel() > 0 and bool((keys < 3 * per_doc).all()),
                  "hybrid 10M: hits outside the 3 routed docs")
            check(bool(torch.isfinite(f.score).all()), "hybrid 10M: non-finite scores")
        t = statistics.median(runs)
        fused_of[rt] = fused
        out[f"hybrid_10m_rt{rt}"] = dict(launches=launches, k3_regimes=regimes,
                                         qps=Q_BATCH * REPS / t,
                                         window_ms=[r_ * 1e3 for r_ in runs])
        log(f"hybrid 10M int8 (6 docs, 3 routed, {REPS} calls x {Q_BATCH} queries, "
            f"scan_rt={rt}): median of 3 windows {t * 1e3:.2f} ms = "
            f"{Q_BATCH * REPS / t:.1f} queries/s (runs "
            f"{', '.join(f'{r_ * 1e3:.2f}' for r_ in runs)} ms); launches {launches}, "
            f"K3 by regime {regimes}")

    # K3 as dense_hits runs it on each routed slot of one hybrid request:
    # the request's int8 codes against buf[ws : ws + wl] with the slot's
    # emb_scale slice, bitwise equal to plain; dense_topk returns K3's result
    from rag_challenge_2_tpu_torch.ops.quant import quantize_rows
    from rag_challenge_2_tpu_torch.ops.topk import dense_topk

    q0 = hreqs[0].q
    q8, qs = quantize_rows(q0)
    for m in range(3):
        s0, s1 = int(ws[m]), int(ws[m] + wl[m])
        e_m, sc_m = data["buf"][s0:s1], data["scales"][s0:s1]
        zero_counts()
        _, kv, ki = compare_k3(f"hybrid slot {m} ({s1 - s0} rows)", q8, e_m, 30,
                               exact=True, q_scale=qs, row_scale=sc_m)
        check(k3_regimes()["int8_small"] == 1,
              f"hybrid 10M slot {m}: K3 must run its small regime: {k3_regimes()}")
        dv, di = dense_topk(q0, e_m, 30, row_scale=sc_m)
        check(torch.equal(dv, kv) and torch.equal(di.long(), ki.long()),
              f"hybrid 10M slot {m}: dense_topk differs from K3")
    log(f"hybrid 10M: K3 on each routed slot ({int(wl[0])} rows, B={Q_BATCH}, "
        "emb_scale slice, small regime) bitwise equal to plain; dense_topk == K3")
    out["hybrid_10m_profile"] = profile_hybrid10m(
        dev, idx, hreqs, dataclasses.replace(c, scan_rt=None), per_doc, data)
    # what phase 11e drives through the sharded engine and holds against
    data["hybrid"] = dict(idx=idx, hreqs=hreqs, cfg=dataclasses.replace(c, scan_rt=None),
                          window=per_doc, fused=[f.to("cpu") for f in fused_of[None]])
    overlap = []
    for a, b in zip(fused_of[None], fused_of[0.95]):
        ka = set(a.key.tolist()) - {-1}
        kb = set(b.key.tolist()) - {-1}
        overlap.append(len(ka & kb) / max(1, len(ka)))
    out["hybrid_10m_overlap"] = float(np.mean(overlap))
    log(f"hybrid 10M top-n overlap, scan_rt 0.95 vs exact: {np.mean(overlap):.4f} "
        "(scan_rt is computed exactly on the card)")
    check(out["hybrid_10m_overlap"] == 1.0, "scan_rt must not change the results")
    log("== phase 7d: graph traversal on the 10M int8 store")
    out["traversal_10m"] = phase7d_int8_10m(dev, idx, hreqs, c, per_doc)
    return out


def phase6_scan10m(dev, seed, ctx3, ctx5):
    import torch

    log("== phase 6: the 10M-row int8 scan (BASELINE config 5 on one card)")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    k3_1m = phase6a_1m(dev, flush, ctx5)
    ctx5.clear()                                           # phase 5's 1M stores
    torch.cuda.empty_cache()
    data = make_10m(dev, seed)
    k3_10m = phase6a_10m(dev, flush, data)
    del flush
    p6b = phase6b_scans(dev, data)
    for name in ("rbuf", "rscales", "rassign"):            # the residual store
        del data[name]
    torch.cuda.empty_cache()
    p6c = phase6c_engine(dev, gen, ctx3, data)
    log(f"phase 6 took {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    # phase 11 takes the 10M store, its oracle and 6c's hybrid from here
    return dict(k3_1m=k3_1m, k3_10m=k3_10m, scans=p6b, engine=p6c), data


# --------------------------------------------------------------- phase 7

TRAV_METHODS = ("ssg", "triangulation", "hybrid_expansion")
# Two step scores closer than this window count as tied: the kernels sum in
# another order than the plain hops (differences of a few 1e-7 on unit rows),
# and a tied choice may then fall either way.  Triangulation's step score
# 1 / (1 + dist) moves about a tenth as much as the dot products under it,
# and its scores lie as much closer together: its window is narrower.
TRAV_TIE = {True: 4e-6, False: 1e-6}          # by "the walk is SSG"


def busy_share(fn):
    """``(wall ms, summed device kernel ms)`` of one ``fn()`` under
    ``torch.profiler``; their ratio is the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, sum(device_us(ev) for ev in prof.key_averages()) / 1e3


def profile_steps(fn, n):
    """One ``torch.profiler`` window over ``n`` calls of ``fn()`` (after
    one call outside it): ``(wall ms, summed device kernel ms, device
    kernels a call, runtime launch calls a call, the 6 kernels with the
    most device time a call as [(name, ms, count)])``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, kernels, launches = [], 0, 0
    for ev in prof.key_averages():
        us = device_us(ev)
        if us:
            kernels += ev.count
            rows.append((ev.key[:60], us / 1e3 / n, ev.count // n))
        elif ev.key.startswith("cudaLaunchKernel"):
            launches += ev.count
    check(kernels > 0, "profiler window with no device time")
    return (wall_ms, sum(r[1] for r in rows) * n, kernels // n, launches // n,
            sorted(rows, key=lambda r: -r[1])[:6])


def check_walkers(name, walkers, left, cut_off):
    """At most 1% of the walkers may be tied: left out for a tie their
    records show, or differing behind a tie at a hop's cut-off, which
    :func:`same_paths` has proved for each of them."""
    check(left + cut_off <= 0.01 * walkers,
          f"{name}: of {walkers} walkers {left} are left out as tied and {cut_off} "
          f"differ behind a proven tie at a hop's cut-off (> 1% together)")


def cutoff_gap(index, chunk, k):
    """The gap between ranks k and k + 1 of ``chunk``'s hop scan, computed
    apart from the traversal: plain f32 products of the chunk's vector with
    its document's rows (dequantized for an int8 store).  None when the
    document has no row to cut off."""
    import torch

    rows = ((index.doc_id == index.doc_id[chunk]) & index.valid).nonzero().flatten()

    def vecs(r):
        v = index.emb[r].float()
        return v if index.emb_scale is None else v * index.emb_scale[r][:, None]

    if rows.numel() <= k:
        return None
    top = (vecs(rows) @ vecs(torch.tensor([chunk], device=rows.device))[0]).topk(k + 1).values
    return float(top[k - 1] - top[k])


def clear_walkers(res, ssg):
    """Walkers of one TraversalResult whose every choice is clear of ties:
    the best two step scores of every hop, and for SSG consecutive hop
    scores (its strict-improvement bar), apart by more than TRAV_TIE's window."""
    cs, ci, hs, path = res.cand_scores, res.cand_ids, res.hop_score, res.path
    tie = TRAV_TIE[ssg]
    ok = ~((ci[:, :, 1] >= 0) & ((cs[:, :, 0] - cs[:, :, 1]).abs() <= tie)).any(1)
    if ssg:
        ok &= ~((path[:, 2:] >= 0) & ((hs[:, 2:] - hs[:, 1:-1]).abs() <= tie)).any(1)
    return ok


def same_paths(name, got, ref, ssg, index, k):
    """Two TraversalResults of the same walkers over ``index``, held equal
    (paths, candidate records, scores within 1e-4) for every walker that
    starts from the same anchor in both and is clear of ties in both.

    One tie no record shows: a hop keeps ``k`` candidates, and whether the
    last of them tied with the row that was cut off is not recorded.
    Triangulation ranks the k by another score, so that last candidate may
    stand anywhere in its record, or be the step.  For every walker clear
    of visible ties that still differs, the hop where it first differs is
    scanned again (:func:`cutoff_gap`): its ranks k and k + 1 must tie, or
    the run fails.  Returns ``(walkers, left out as tied, differing behind
    a proven cut-off tie)``."""
    import torch

    got, ref = (type(r)(*(x.cpu() for x in r)) for r in (got, ref))
    active = (got.path[:, 0] >= 0) | (ref.path[:, 0] >= 0)
    ok = (clear_walkers(got, ssg) & clear_walkers(ref, ssg)
          & (got.path[:, 0] == ref.path[:, 0]))
    # a recorded candidate is compared where its score is clear of both its
    # neighbours in the record (the last one's next neighbour is not kept)
    gap = (ref.cand_scores[..., :-1] - ref.cand_scores[..., 1:]).abs() > TRAV_TIE[ssg]
    edge = torch.ones_like(gap[..., :1])
    sel = torch.cat([edge, gap], -1) & torch.cat([gap, ~edge], -1) & (ref.cand_ids >= 0)
    step_differs = got.path[:, 1:] != ref.path[:, 1:]                       # [A, H]
    hop_differs = step_differs | ((got.cand_ids != ref.cand_ids) & sel).any(2)
    differ = ok & hop_differs.any(1)
    for n, a in enumerate(differ.nonzero().flatten().tolist()):
        h = int(hop_differs[a].float().argmax())     # the paths agree up to hop h
        # the scan's scores are dot products in both modes: SSG's window
        cut = cutoff_gap(index, int(ref.path[a, h]), k)
        proven = cut is not None and abs(cut) <= TRAV_TIE[True]
        if n < 2 or not proven:
            log(f"  {name}: walker {a} differs at hop {h} (ranks {k} and {k + 1} of its "
                f"scan are {cut!r} apart): paths {got.path[a].tolist()} / "
                f"{ref.path[a].tolist()}; records {got.cand_ids[a, h].tolist()} "
                f"{[round(x, 7) for x in got.cand_scores[a, h].tolist()]} / "
                f"{ref.cand_ids[a, h].tolist()} "
                f"{[round(x, 7) for x in ref.cand_scores[a, h].tolist()]}")
        check(proven, f"{name}: walker {a} differs at hop {h} with no tie in sight: ranks "
              f"{k} and {k + 1} of its scan are {cut!r} apart")
    same = ok & ~differ
    for a, b in ((got.hop_score, ref.hop_score), (got.cand_scores, ref.cand_scores)):
        check(bool(((a[same] - b[same]).abs() <= K1_TOL).all()),
              f"{name}: hop scores differ")
    return int(active.sum()), int((active & ~ok).sum()), int(differ.sum())


def with_given_paths(search, given):
    """Run ``search()`` (a reference engine's call) with the engine's
    ``run_traverse`` handing on ``given``'s paths (TraversalResults by
    mode) in place of its own.  A walker whose choice is tied may step
    elsewhere on the card than in the reference, and its hits then differ;
    fusing the reference's own blocks over the card's paths holds emission
    and fusion to the reference all the same.  Returns ``(search()'s
    result, the reference's own TraversalResults by mode)``."""
    import rag_challenge_2_tpu_torch.retrieval.engine as engine_mod

    real, own = engine_mod.run_traverse, {}

    def handing_on(index, req, cfg, window, anchors_pm, mode, n_requests=1):
        res, qids, qv = real(index, req, cfg, window, anchors_pm, mode, n_requests)
        own[mode] = res
        return type(res)(*(x.to(res.path.device) for x in given[mode])), qids, qv

    engine_mod.run_traverse = handing_on
    try:
        return search(), own
    finally:
        engine_mod.run_traverse = real


def paths_by_mode(details, cfg):
    """``{mode: TraversalResult}`` of one request's details."""
    if "trav" in details:
        return {cfg.method: details["trav"]}
    return {"ssg": details["ssg"], "triangulation": details["tri"]}


def same_blocks(name, got, ref):
    """The arms' hit blocks of one request, the card's against the
    reference's (walked over the same paths): validity equal, similarities
    within 1e-4, rows equal wherever a similarity is clear of its
    neighbours in the block's row (the last rank may tie with the row that
    was cut off, which the block does not show)."""
    import torch

    check(len(got) == len(ref), f"{name}: {len(got)} blocks against {len(ref)}")
    for b, (g, r) in enumerate(zip(got, ref)):
        rows_g, sims_g, qids_g, mids_g, ok_g = (x.cpu() for x in g)
        rows_r, sims_r, qids_r, mids_r, ok_r = (x.cpu() for x in r)
        check(torch.equal(qids_g, qids_r) and torch.equal(mids_g, mids_r),
              f"{name}: block {b}: query or method ids differ")
        both = ok_g & ok_r
        err = ((sims_g - sims_r).abs() * both).max().item()
        check(err <= K1_TOL, f"{name}: block {b}: similarities differ by {err}")
        mids = int(mids_r.flatten()[0])
        if mids in (1, 2):                 # traversal: the paths were handed on
            check(torch.equal(ok_g, ok_r) and torch.equal(rows_g, rows_r),
                  f"{name}: block {b}: emitted rows differ from the paths")
            continue
        u = untied(torch.where(ok_r, sims_r, torch.full_like(sims_r, -1.0)), K1_TOL)
        u[:, -1] = False
        check(torch.equal(ok_g[u], ok_r[u]) and torch.equal(rows_g[u & both], rows_r[u & both]),
              f"{name}: block {b}: rows differ where similarities are not tied")


def against_reference(name, index, ref_index, cfg, arms, ref_arms, details_with):
    """One request on the card against a reference: the arms' blocks
    (:func:`same_blocks`, the reference walking the card's paths), the
    card's fusion against the reference's fusion of the card's blocks, and
    the card's paths and details against the reference's own
    (:func:`same_details`, with ``details_with`` an engine).  A tie at a
    block's cut-off may put another row into the fused list on the card, so
    fusion is held to the reference over the same blocks.  Returns
    ``(walkers, left out as tied, differing behind a proven cut-off tie, tie
    groups reordered in the fused list)``."""
    from rag_challenge_2_tpu_torch.retrieval.engine import fuse_blocks

    blocks, details = arms()
    (ref_blocks, ref_details), own = with_given_paths(ref_arms, paths_by_mode(details, cfg))
    same_blocks(name, blocks, ref_blocks)
    dev_ref = ref_index.emb.device
    moved = [tuple(x.to(dev_ref) for x in b) for b in blocks]
    reordered = same_candidates(fuse_blocks(index, blocks, cfg),
                                fuse_blocks(ref_index, moved, cfg), 1e-4)
    ref_details = dict(ref_details, **{
        key: own[cfg.method if key == "trav" else
                 {"ssg": "ssg", "tri": "triangulation"}[key]]
        for key in ("trav", "ssg", "tri") if key in ref_details})
    return (*same_details(name, details_with, index, cfg, details, ref_details), reordered)


def same_details(name, eng, index, cfg, got, ref):
    """The two engines' details of one request over ``index``: every traversal's paths
    (:func:`same_paths`), and the ``materialize_details`` payloads: equal
    keys and counts, scores within 1e-4, whenever no walker was left out or
    differs.  Returns :func:`same_paths`' counts, summed."""
    walkers = left = cut_off = 0
    for key in got:
        if key in ("trav", "ssg", "tri"):
            ssg = key == "ssg" or cfg.method == "ssg"
            w, out, un = same_paths(f"{name} {key}", got[key], ref[key], ssg, index,
                                    cfg.neighbor_k + 1)
            walkers, left, cut_off = walkers + w, left + out, cut_off + un
    if left == cut_off == 0 and eng is not None:
        def same(a, b, where="details"):
            if where.endswith(".candidates"):
                # tied candidates may swap inside a record: scores by rank,
                # and the selected one by row
                check(len(a) == len(b), f"{name}: details lengths differ at {where}")
                same([c["score"] for c in a], [c["score"] for c in b], where + ".score")
                same([c["idx"] for c in a if c["selected"]],
                     [c["idx"] for c in b if c["selected"]], where + ".selected")
            elif isinstance(a, dict):
                check(a.keys() == b.keys(), f"{name}: details keys differ at {where}")
                for k in a:
                    same(a[k], b[k], f"{where}.{k}")
            elif isinstance(a, list):
                check(len(a) == len(b), f"{name}: details lengths differ at {where}")
                for i, (x, y) in enumerate(zip(a, b)):
                    same(x, y, f"{where}[{i}]")
            elif isinstance(a, float):
                check(abs(a - b) <= K1_TOL, f"{name}: details differ at {where}: {a} vs {b}")
            else:
                check(a == b, f"{name}: details differ at {where}: {a} vs {b}")

        mine, theirs = eng.materialize_details(got, cfg), eng.materialize_details(ref, cfg)
        if "basic_rows" in got:
            # a tie at the basic block's cut-off changes which rows count as
            # "in the basic top 50": the contribution stats then differ
            def rows(d):
                return set(d["basic_rows"][d["basic_ok"]].tolist())

            if rows(got) != rows(ref):
                mine["algorithm_contribution"] = theirs["algorithm_contribution"] = None
        same(mine, theirs)
    return walkers, left, cut_off


def phase7a_hop_shapes(dev, gen):
    """K1 and K3 (f32 / bf16 forms) at the traversal's hop shapes through
    ``ops.topk.dense_topk``: k = neighbor_k + 1 = 31, A = 8 walkers (K1),
    80 (K3) and 160 (K3, 128 + 32), over one document of the deployment
    corpus (1,700 rows) and of the scale corpus (250,000 rows; once more
    under a row-shared mask, the full-corpus tier's call), against plain
    and timed beside the bound and ``matmul`` + ``topk``."""
    import torch

    from rag_challenge_2_tpu_torch.ops.dense_topk import dense_topk_plain
    from rag_challenge_2_tpu_torch.ops.topk import dense_topk

    log("== phase 7a: K1 / K3 at the traversal's hop shapes")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    D, k = 1024, 31
    q160 = unit_rows(160, D, gen, dev)
    out, err_max = {}, 0.0
    for N in (1_700, 250_000):
        base = unit_rows(N, D, gen, dev)
        masks = [None] + ([torch.rand(N, generator=gen, device=dev) > 0.5]
                          if N == 250_000 else [])
        for dt in (torch.float32, torch.bfloat16):
            emb = base.to(dt)
            short = str(dt).split(".")[1]
            for A, want in ((8, dict(dense_topk=1, stream_topk=0)),
                            (80, dict(dense_topk=0, stream_topk=1)),
                            (160, dict(dense_topk=0, stream_topk=2))):
                qa = q160[:A].contiguous()
                for mask in masks:
                    name = f"N={N} {short} A={A}" + (" masked" if mask is not None else "")
                    zero_counts()
                    kv, ki = dense_topk(qa, emb, k, mask=mask)
                    got = {n: c for n, c in read_counts().items() if n in want}
                    check(got == want, f"hop {name}: launches {got}, expected {want}")
                    pv, pi = dense_topk_plain(qa, emb, k, mask)
                    torch.cuda.synchronize()
                    err = (kv - pv).abs().max().item()
                    check(kv.shape == pv.shape and err <= K1_TOL,
                          f"hop {name}: max abs diff {err} > {K1_TOL}")
                    bad = untied(pv, K1_TOL) & (ki != pi)
                    bad[:, -1] = False    # the last rank may tie with the row cut off
                    if bool(bad.any()):
                        r, c = bad.nonzero()[0].tolist()
                        check(False, f"hop {name}: {int(bad.sum())} untied rows differ, first "
                              f"at query {r} rank {c}: kernel row {int(ki[r, c])} "
                              f"({float(kv[r, c])!r}), plain row {int(pi[r, c])} "
                              f"({float(pv[r, c])!r}); kernel rows {ki[r].tolist()}, plain "
                              f"rows {pi[r].tolist()}")
                    err_max = max(err_max, err)
                    ms = cuda_ms(lambda: dense_topk(qa, emb, k, mask=mask), flush, reps=11)
                    pms = cuda_ms(lambda: dense_topk_plain(qa, emb, k, mask), flush, reps=7)
                    lib = None if mask is not None else library_time(
                        "hop", lambda: torch.topk(
                            torch.matmul(qa.to(dt), emb.T).float(), k, dim=1), flush, reps=7)
                    bnd = bound(N * D * emb.element_size() + A * D * 4 + 8 * A * k
                                + (N if mask is not None else 0), 2 * A * N * D, F32_OPS_S)
                    out[name] = dict(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=bnd[0],
                                     bound_by=bnd[1], err=err,
                                     kernel="K1" if want["dense_topk"] else "K3")
                    log(f"hop {name} k={k} ({out[name]['kernel']}, {sum(want.values())} "
                        f"launch(es)): max|diff| {err:.3g}  kernel {share(ms, bnd)}  plain "
                        f"{pms:.4f} ms  matmul + topk {lib if lib is None else f'{lib:.4f}'} ms")
    out["err"] = err_max
    return out


def phase7b_deploy(dev, ctx3):
    """The three traversal methods on phase 3's corpus and requests, each
    with and without BM25: the card's fused candidates, paths and details
    against the same engine on a CPU copy of the index (plain hops); launch
    counts per request; ``search_many`` of three stacked hybrid_expansion
    requests against three ``search`` calls; a planted chunk's nearest
    neighbour is reached;
    hybrid_expansion's per-stage split and busy share; the same on the int8
    variant of the corpus, whose hops are plain PyTorch."""
    import torch

    from rag_challenge_2_tpu_torch.index import quantize_index
    from rag_challenge_2_tpu_torch.retrieval import QueryEngine, SearchConfig
    from rag_challenge_2_tpu_torch.retrieval.engine import (
        HYBRID_BASIC_K, HYBRID_SSG_ANCHORS, HYBRID_TRI_ANCHORS, _arms as arms,
        bm25_hits, dense_hits, fuse_blocks, run_traverse)
    from rag_challenge_2_tpu_torch.retrieval.traversal import emit_hits

    log("== phase 7b: graph traversal on the deployment corpus")
    eng, reqs = ctx3["eng"], ctx3["requests"]
    cpu_eng = QueryEngine(eng.index.to("cpu"), eng.meta)
    R = len(reqs)
    out = {}

    def run_all(e, cfg, which=reqs):
        return [e.search(qe, COMPANY, question, years, cfg, query_texts=qtexts,
                         with_details=True)
                for question, qtexts, years, qe in which]

    def against_cpu(name, e, cpu_e, cfg, rq):
        """One request on engine ``e`` against the CPU engine ``cpu_e``."""
        question, qtexts, years, qe = rq
        rg = e.prepare(qe, COMPANY, question, years, cfg, qtexts)
        rc = cpu_e.prepare(qe.cpu(), COMPANY, question, years, cfg, qtexts)
        return against_reference(
            name, e.index, cpu_e.index, cfg,
            lambda: arms(e.index, rg, cfg, e.window, None),
            lambda: arms(cpu_e.index, rc, cfg, cpu_e.window, None), e)

    # Q = 8 padded queries, 3 routed slots, 4 hops: the anchors' top-1 and
    # every hop of 8 walkers are K1 calls; hybrid_expansion's basic block is
    # K1, its 80 SSG walkers per slot one K3 call a hop, its 160
    # triangulation walkers two (128 + 32)
    expected = {"ssg": dict(dense_topk=3 + 12, stream_topk=0),
                "triangulation": dict(dense_topk=3 + 12, stream_topk=0),
                "hybrid_expansion": dict(dense_topk=3, stream_topk=12 + 24)}
    for method in TRAV_METHODS:
        for use_bm25 in (False, True):
            cfg = SearchConfig(method=method, top_k=30, top_n=30, use_bm25=use_bm25,
                               bm25_top_k=30)
            name = method + ("+bm25" if use_bm25 else "")
            run_all(eng, cfg, reqs[:2])                        # warm-up
            zero_counts()
            got, t = wall(lambda: run_all(eng, cfg), dev)
            launches = read_counts()
            per_req = {n: launches[n] / R for n in ("dense_topk", "stream_topk")}
            check(per_req == expected[method] and k3_regimes()["float"]
                  == launches["stream_topk"] and (launches["span_gather"] > 0) == use_bm25,
                  f"{name}: launches per request {per_req} ({launches}), expected "
                  f"{expected[method]}: the hops must run K1 / K3")
            tot = [0, 0, 0, 0]      # walkers, left out, differing at a cut-off, reordered
            for rq, (c, _) in zip(reqs, got):
                check(bool((c.key >= 0).any()) and bool(torch.isfinite(c.score).all()),
                      f"{name}: no hits or non-finite scores")
                tot = [a + b for a, b in zip(tot, against_cpu(name, eng, cpu_eng, cfg, rq))]
            walkers, left, cut_off, reordered = tot
            check_walkers(name, walkers, left, cut_off)
            out[name] = dict(ms_per_request=t / R * 1e3, launches_per_request=per_req,
                             walkers=walkers, left_out=left, differ_cut_off=cut_off,
                             reordered_ties=reordered)
            log(f"{name}: GPU engine == CPU plain engine on all {R} requests (every "
                f"arm's hits within 1e-4 and rows equal where untied, the fusion of the "
                f"same hits equal, tie groups reordered: {reordered}; paths and "
                f"details equal on {walkers - left - cut_off} of {walkers} walkers, {left} "
                f"left out as tied, {cut_off} differ behind a proven tie at a hop's cut-off); "
                f"{t / R * 1e3:.2f} ms/request; launches per request "
                f"K1 {per_req['dense_topk']:g}, K3 {per_req['stream_topk']:g}")

    # search_many with a traversal method: three same-route requests stacked.
    # The basic block's 24 queries a slot stay with K1; a slot's 3 x 80 SSG
    # walkers hop as 128 + 112 (two K3 launches), its 3 x 160 triangulation
    # walkers as 3 x 128 + 96 (four); 4 hops, 3 slots
    cfg = SearchConfig(method="hybrid_expansion", top_k=30, top_n=30, use_bm25=True,
                       bm25_top_k=30)
    question, _, years, _ = reqs[0]
    three = [r for r in reqs if r[2] == years][:3]
    check(len(three) == 3, "fewer than 3 requests share the first one's route")

    def stacked():
        return eng.search_many([qe for *_, qe in three], COMPANY, question, years, cfg,
                               query_texts_list=[tx for _, tx, _, _ in three])

    stacked()                                                  # warm-up
    zero_counts()
    many, t = wall(stacked, dev)
    launches = read_counts()
    want = dict(dense_topk=3, stream_topk=3 * 4 * (2 + 4))
    check({n: launches[n] for n in want} == want and k3_regimes()["float"]
          == launches["stream_topk"],
          f"search_many hybrid_expansion: launches {launches}, expected {want}")
    singles, t_one = wall(lambda: [
        eng.search(qe, COMPANY, question, years, cfg, query_texts=tx)
        for _, tx, _, qe in three], dev)
    reordered = sum(same_candidates(m, one, 1e-4) for m, one in zip(many, singles))
    out["search_many_hybrid"] = dict(
        ms_per_request=t / 3 * 1e3, separate_ms_per_request=t_one / 3 * 1e3,
        launches={n: launches[n] for n in want}, reordered_ties=reordered)
    log(f"search_many of 3 hybrid_expansion+bm25 requests == 3 search calls (fused keys, "
        f"counts, scores within 1e-4; tie groups reordered: {reordered}); launches K1 "
        f"{launches['dense_topk']}, K3 {launches['stream_topk']} for the 3; "
        f"{t / 3 * 1e3:.2f} ms/request stacked, {t_one / 3 * 1e3:.2f} as separate calls")

    # planted: the walk from a chunk's own embedding starts at that chunk and
    # first steps to its nearest neighbour inside its document
    idx = eng.index
    cfg = SearchConfig(method="ssg", top_k=30, top_n=30)
    for d in (1, 3, 4):
        ws, wl = eng._doc_ranges[d]
        row = ws + wl // 3
        qv = idx.emb[row].float()[None]
        sims = (qv @ idx.emb[ws:ws + wl].float().T)[0]
        sims[row - ws] = -1.0
        top2 = sims.topk(2)
        if (top2.values[0] - top2.values[1]).item() <= TRAV_TIE[True]:
            continue
        cands, det = eng.search(qv, COMPANY, "", [eng.meta.docs[d].year], cfg,
                                with_details=True)
        path = det["trav"].path
        mine = path[path[:, 0] == row]
        check(mine.shape[0] == 1 and int(mine[0, 1]) == ws + int(top2.indices[0]),
              f"planted chunk {row}: first hop {mine.tolist()} is not its nearest "
              f"neighbour {ws + int(top2.indices[0])}")
        rows = {r["rep_row"] for r in eng.materialize(cands, cfg)}
        check({int(x) for x in mine[0] if x >= 0} <= rows,
              f"planted chunk {row}: its path is missing from the hits")
    log("planted chunks: each walk starts at the chunk and first steps to its "
        "nearest neighbour; the path is among the hits")

    # hybrid_expansion + BM25: per-stage split (synchronised after each stage)
    cfg = SearchConfig(method="hybrid_expansion", top_k=30, top_n=30, use_bm25=True,
                       bm25_top_k=30)
    stages = dict(basic=0.0, ssg_hops=0.0, tri_hops=0.0, emit=0.0, bm25=0.0, fuse=0.0)
    for question, qtexts, years, qe in reqs:
        rq = eng.prepare(qe, COMPANY, question, years, cfg, qtexts)
        bd, t = wall(lambda: dense_hits(idx, rq, cfg, eng.window, HYBRID_BASIC_K), dev)
        stages["basic"] += t
        anchors = torch.where(bd[4], bd[0], torch.full_like(bd[0], -1))
        blocks = [bd]
        for stage, mode, n in (("ssg_hops", "ssg", HYBRID_SSG_ANCHORS),
                               ("tri_hops", "triangulation", HYBRID_TRI_ANCHORS)):
            (res, qids, qv), t = wall(lambda: run_traverse(
                idx, rq, cfg, eng.window, anchors[:, :n], mode), dev)
            stages[stage] += t
            (rows, sims), t = wall(lambda: emit_hits(idx.emb, qv, res), dev)
            stages["emit"] += t
            blocks.append((rows, sims, qids[:, None].expand(rows.shape),
                           torch.full_like(rows, 1 if mode == "ssg" else 2), res.valid))
        bb, t = wall(lambda: bm25_hits(idx, rq, cfg, eng.window), dev)
        stages["bm25"] += t
        _, t = wall(lambda: fuse_blocks(idx, blocks + [bb], cfg), dev)
        stages["fuse"] += t
    stage_ms = {k: v / R * 1e3 for k, v in stages.items()}
    wall_ms, device_ms = busy_share(lambda: run_all(eng, cfg))
    out["hybrid_split"] = dict(stage_ms=stage_ms, wall_ms=wall_ms, device_ms=device_ms,
                               busy=device_ms / wall_ms)
    log("hybrid_expansion+bm25 per-stage ms/request: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()))
    log(f"hybrid_expansion+bm25 profiled window of {R} requests: wall {wall_ms:.2f} ms, "
        f"device kernels {device_ms:.2f} ms = {100 * device_ms / wall_ms:.1f}% busy")

    # the int8 variant: the basic block is K3's int8 form, every hop plain
    eng8 = QueryEngine(quantize_index(idx), eng.meta)
    cpu8 = QueryEngine(eng8.index.to("cpu"), eng.meta)
    some = reqs[:4]
    run_all(eng8, cfg, some[:1])
    zero_counts()
    got, t = wall(lambda: run_all(eng8, cfg, some), dev)
    launches = read_counts()
    check(launches["dense_topk"] == 0 and launches["stream_topk"] == 3 * len(some)
          and k3_regimes()["float"] == 0,
          f"int8 hybrid_expansion: only the basic block may launch K3: {launches}")
    tot = [0, 0, 0, 0]
    for rq in some:
        tot = [a + b for a, b in zip(tot, against_cpu("int8 hybrid_expansion", eng8,
                                                      cpu8, cfg, rq))]
    walkers, left, cut_off, _ = tot
    check_walkers("int8 hybrid_expansion", walkers, left, cut_off)
    out["hybrid_int8"] = dict(ms_per_request=t / len(some) * 1e3, walkers=walkers,
                              left_out=left, differ_cut_off=cut_off)
    log(f"hybrid_expansion+bm25 on the int8 store: GPU == CPU engine on {len(some)} "
        f"requests ({left} of {walkers} walkers left out as tied, {cut_off} differ "
        f"behind a proven cut-off tie); plain hops (K3 only "
        f"in the basic block: {launches['stream_topk']} launches); "
        f"{t / len(some) * 1e3:.2f} ms/request")
    return out


def phase7c_scale(dev, ctx4):
    """hybrid_expansion on phase 4's store (1.5M x 1024 bf16, 250,000 rows a
    slot, 3 of 6 routed): 16 calls of 8 queries; 2 of them against the same
    hops done by ``matmul`` + a stable sort on the card; queries/s, the
    per-stage split, busy share and the overlap of the fused hits with the
    basic method's; and 8 basic requests stacked into one
    ``search_many_device`` against 8 separate calls."""
    import dataclasses

    import torch

    import rag_challenge_2_tpu_torch.retrieval.traversal as tv
    from rag_challenge_2_tpu_torch.ops.dense_topk import dense_topk_plain
    from rag_challenge_2_tpu_torch.retrieval import search_device
    from rag_challenge_2_tpu_torch.retrieval.engine import _arms as arms
    from rag_challenge_2_tpu_torch.retrieval.engine import search_many_device

    idx, reqs, per_doc = ctx4["idx"], ctx4["reqs"], ctx4["per_doc"]
    log(f"== phase 7c: hybrid_expansion at scale ({idx.emb.shape[0]} x "
        f"{idx.emb.shape[1]} bf16, {per_doc} rows a slot)")
    cfg = dataclasses.replace(ctx4["cfg"], method="hybrid_expansion")
    Q = cfg.max_queries

    def window():
        return [search_device(idx, rq, cfg, window=per_doc) for rq in reqs]

    window()                                               # warm-up
    zero_counts()
    runs = []
    for _ in range(3):
        got, t = wall(window, dev)
        runs.append(t)
    launches = read_counts()
    per_call = {n: launches[n] / (3 * len(reqs)) for n in ("dense_topk", "stream_topk")}
    check(per_call == dict(dense_topk=3, stream_topk=36),
          f"scale hybrid_expansion: launches per call {per_call}, expected K1 3, K3 36")
    t = statistics.median(runs)
    for f, _ in got:
        keys = f.key[f.key >= 0]
        check(keys.numel() > 0 and bool((keys < 3 * per_doc).all()),
              "scale hybrid_expansion: hits outside the 3 routed docs")
        check(bool(torch.isfinite(f.score).all()), "scale: non-finite scores")

    # the same hops by matmul (TF32 off) + a stable sort, on the card
    real = tv.dense_topk

    def plain_hop(q, emb, k, mask=None):
        return dense_topk_plain(q, emb, k, mask)

    tv.dense_topk = plain_hop
    tot = [0, 0, 0, 0]
    try:
        zero_counts()
        for rq in reqs[:2]:
            def on_card(rq=rq):
                tv.dense_topk = real
                try:
                    return arms(idx, rq, cfg, per_doc, None)
                finally:
                    tv.dense_topk = plain_hop

            tot = [a + b for a, b in zip(tot, against_reference(
                "scale hybrid_expansion", idx, idx, cfg, on_card,
                lambda rq=rq: arms(idx, rq, cfg, per_doc, None), None))]
        counts = read_counts()
        # per call: the basic block's 3 K1 launches on either side, and the
        # card's 36 K3 hops; the plain hops launch nothing
        check(counts["dense_topk"] == 12 and counts["stream_topk"] == 72,
              f"scale: the plain hops must launch no kernel: {counts}")
    finally:
        tv.dense_topk = real
    walkers, left, cut_off, _ = tot
    check_walkers("scale hybrid_expansion", walkers, left, cut_off)

    basic = [search_device(idx, rq, ctx4["cfg"], window=per_doc)[0] for rq in reqs]
    overlap = []
    for (f, _), b in zip(got, basic):
        kf, kb = set(f.key.tolist()) - {-1}, set(b.key.tolist()) - {-1}
        overlap.append(len(kf & kb) / max(1, len(kb)))
    overlap = sum(overlap) / len(overlap)
    # the batcher's case at this size: 8 basic requests stacked into one
    # search_many_device (64 queries a slot) against 8 separate calls
    eight, bcfg = reqs[:8], ctx4["cfg"]
    search_many_device(idx, eight, bcfg, window=per_doc)       # warm-up
    stacked_runs, separate_runs = [], []
    for _ in range(3):
        many, ts = wall(lambda: search_many_device(idx, eight, bcfg, window=per_doc), dev)
        stacked_runs.append(ts / 8 * 1e3)
        _, ts = wall(lambda: [search_device(idx, rq, bcfg, window=per_doc)
                              for rq in eight], dev)
        separate_runs.append(ts / 8 * 1e3)
    for m, b in zip(many, basic):
        same_candidates(m, b, 1e-4)
    log(f"scale basic+bm25, 8 requests: stacked in one search_many_device "
        f"{statistics.median(stacked_runs):.2f} ms/request (runs "
        f"{', '.join(f'{r:.2f}' for r in stacked_runs)}), as 8 separate calls "
        f"{statistics.median(separate_runs):.2f} (runs "
        f"{', '.join(f'{r:.2f}' for r in separate_runs)}); answers equal")
    wall_ms, device_ms = busy_share(window)
    qps = Q * len(reqs) / t
    log(f"scale hybrid_expansion+bm25: {len(reqs)} calls x {Q} queries, median of 3 "
        f"windows {t * 1e3:.1f} ms = {qps:.1f} queries/s, {t / len(reqs) * 1e3:.2f} "
        f"ms/call (runs {', '.join(f'{r * 1e3:.1f}' for r in runs)} ms); launches per "
        f"call K1 {per_call['dense_topk']:g}, K3 {per_call['stream_topk']:g}; 2 calls == "
        f"matmul + stable-sort hops ({left} of {walkers} walkers left out as tied, {cut_off} "
        f"differ behind a proven cut-off tie); "
        f"overlap@{cfg.top_n} with the basic method's hits {overlap:.3f}; profiled "
        f"window: wall {wall_ms:.1f} ms, device kernels {device_ms:.1f} ms = "
        f"{100 * device_ms / wall_ms:.1f}% busy")
    return dict(qps=qps, ms_per_call=t / len(reqs) * 1e3,
                window_ms=[r * 1e3 for r in runs], launches_per_call=per_call,
                walkers=walkers, left_out=left, differ_cut_off=cut_off, overlap=overlap,
                wall_ms=wall_ms,
                device_ms=device_ms, busy=device_ms / wall_ms,
                stacked8_ms_per_request=stacked_runs, separate8_ms_per_request=separate_runs)


def phase7d_int8_10m(dev, idx, hreqs, cfg, per_doc):
    """ssg and hybrid_expansion on the 10M int8 store (Q = 4, 3 of 6 docs
    routed, 1.67M rows a slot): the hops are plain PyTorch in row blocks, so
    no slot is ever whole in f32: the peak over the resident store must
    stay under 8 GB."""
    import dataclasses

    import torch

    from rag_challenge_2_tpu_torch.retrieval import search_device

    out = {}
    for method in ("ssg", "hybrid_expansion"):
        c = dataclasses.replace(cfg, method=method, scan_rt=None)
        search_device(idx, hreqs[0], c, window=per_doc)      # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        got, t = wall(lambda: [search_device(idx, rq, c, window=per_doc)
                               for rq in hreqs[:2]], dev)
        peak = torch.cuda.max_memory_allocated() - base
        launches = read_counts()
        check(launches["dense_topk"] == 0 and k3_regimes()["float"] == 0,
              f"10M int8 {method}: an int8 hop went through K1 / K3's float form")
        check(peak < 8e9, f"10M int8 {method}: peak {peak / 1e9:.2f} GB over the store")
        for f, d in got:
            keys = f.key[f.key >= 0]
            check(keys.numel() > 0 and bool((keys < 3 * per_doc).all())
                  and bool(torch.isfinite(f.score).all()),
                  f"10M int8 {method}: hits outside the routed docs or non-finite")
            res = d["trav"] if method == "ssg" else d["tri"]
            check(bool((res.path[:, 1:] >= 0).any()), f"10M int8 {method}: no walker stepped")
        out[method] = dict(ms_per_request=t / 2 * 1e3, peak_gb=peak / 1e9,
                           k3_launches=launches["stream_topk"])
        log(f"10M int8 {method}: 2 requests x {c.max_queries} queries, "
            f"{t / 2 * 1e3:.1f} ms/request, peak {peak / 1e9:.2f} GB over the resident "
            f"store (plain hops in blocks; K3 launches {launches['stream_topk']}, all "
            f"in the anchors' / basic block)")
    return out


def phase7e_batcher(dev, ctx3):
    """2, 4 and 8 concurrent same-route basic requests through MicroBatcher
    on the deployment corpus: each answer equals its own search call; the
    stacked batch every dispatch ran K1 / K3 at, and ms per request."""
    import threading

    from rag_challenge_2_tpu_torch.retrieval import SearchConfig
    from rag_challenge_2_tpu_torch.serving import MicroBatcher

    log("== phase 7e: the micro-batcher on the deployment corpus")
    eng = ctx3["eng"]
    question, _, years, _ = ctx3["requests"][0]
    same_route = ([r for r in ctx3["requests"] if r[2] == years] * 8)[:8]   # one route
    cfg = SearchConfig(method="basic", top_k=30, top_n=30, use_bm25=True, bm25_top_k=30)
    singles, t_one = wall(lambda: [
        eng.search(qe, COMPANY, question, years, cfg, query_texts=tx)
        for _, tx, _, qe in same_route], dev)
    out = {"separate_ms_per_request": t_one / 8 * 1e3}
    real = eng.search_many
    for n in (2, 4, 8):
        sizes = []

        def spy(embs, *a, **kw):
            sizes.append(len(embs))
            return real(embs, *a, **kw)

        eng.search_many = spy
        try:
            mb = MicroBatcher(eng, max_batch=n, window_ms=50.0)
            got, errs = [None] * n, []
            barrier = threading.Barrier(n)

            def call(i):
                try:
                    barrier.wait()
                    _, tx, _, qe = same_route[i]
                    got[i] = mb.search(qe, COMPANY, question, years, cfg, query_texts=tx)
                except BaseException as e:
                    errs.append(e)

            def burst():
                ts = [threading.Thread(target=call, args=(i,)) for i in range(n)]
                for x in ts:
                    x.start()
                for x in ts:
                    x.join()

            for _ in range(2):                       # a warm-up burst, then the timed one
                sizes.clear()
                zero_counts()
                _, t = wall(burst, dev)
            check(not errs, f"batcher n={n}: {errs}")
        finally:
            eng.search_many = real
        launches = read_counts()
        for i in range(n):
            same_candidates(got[i], singles[i], 1e-4)
        check(sum(sizes) == n and launches["dense_topk"] + launches["stream_topk"] > 0,
              f"batcher n={n}: dispatch sizes {sizes}, launches {launches}")
        out[f"n={n}"] = dict(dispatch_sizes=list(sizes), ms_per_request=t / n * 1e3,
                             stacked_queries=[s * cfg.max_queries for s in sizes],
                             launches=launches)
        log(f"batcher n={n}: answers == {n} search calls; dispatches of {sizes} requests "
            f"= {[s * cfg.max_queries for s in sizes]} stacked queries a slot; launches "
            f"K1 {launches['dense_topk']}, K3 {launches['stream_topk']}; "
            f"{t / n * 1e3:.2f} ms/request with the 50 ms collection window "
            f"({t_one / 8 * 1e3:.2f} ms/request as separate calls)")
    return out


# --------------------------------------------------------------- phase 8

# The LLM's seat: a scripted stub for page selection, reranking, the answer
# and the judge (the first needle found in a prompt picks the reply)
QA_SCRIPT = {
    "标准答案": {"score": 1.0, "reasoning": "一致", "is_correct": True},
    # 4 blocks a reranking batch, distinct relevance by position; a batch
    # of another size falls back to one block a call
    "文本块集合": {"block_rankings": [{"reasoning": f"r{i}", "relevance_score": s}
                                  for i, s in enumerate((0.9, 0.35, 0.6, 0.75))]},
    "文本块:": {"reasoning": "r", "relevance_score": 0.8},
    "上下文": {"step_by_step_analysis": "一二三四五步骤" * 10, "reasoning_summary": "总结",
            "relevant_pages": [3], "final_answer": 68.9},
}
QA_PAGE = re.compile(r"Text retrieved from page (\d+)")
# payload keys that differ between two runs of the same work
QA_VOLATILE = ("timing", "avg_llm_latency")


def qa_processor(eng, embedder, **cfg):
    """The ``qwen`` preset's QA settings (pipeline/run.py:337-339: parent
    pages, LLM reranking of 30, 4 parallel requests) with hybrid BM25 (sum
    fusion, dense weight 0.5), over ``eng``; a scripted stub answers.  The
    page-selection reply names the 1st and 3rd pages of its prompt."""
    from rag_challenge_2_tpu_torch.llm import (
        LLMFacade, LLMReranker, RateLimiter, StubProvider)
    from rag_challenge_2_tpu_torch.qa import QAConfig, QuestionsProcessor

    class Stub(StubProvider):
        def _complete(self, model, system_content, human_content, temperature, **kw):
            out = super()._complete(model, system_content, human_content, temperature, **kw)
            if "候选页面" in human_content:
                pages = [int(p) for p in QA_PAGE.findall(human_content)]
                return json.dumps({"selected_pages": pages[:3:2], "reasoning": "相关"})
            return out

    stub = Stub(QA_SCRIPT)
    rr = LLMReranker(stub)
    rr.rate_limiter = RateLimiter(0)              # the stub needs no throttle
    qa = QAConfig(return_parent_pages=True, llm_reranking=True,
                  llm_reranking_sample_size=30, parallel_requests=4, use_bm25=True, **cfg)
    return QuestionsProcessor(eng, embedder, LLMFacade(stub), rr, qa), stub


def same_hits(name, got, ref, tol):
    """Two runs' materialised parent-page results: scores within ``tol``
    rank by rank, the pages identical up to the order inside groups of
    scores tied within ``tol`` (a group cut by top_n may differ), each
    page's fields equal.  Returns 1 if a tie group was reordered, else 0."""
    check(len(got) == len(ref), f"{name}: {len(got)} results against {len(ref)}")
    gs, rs = [r["distance"] for r in got], [r["distance"] for r in ref]
    err = max((abs(a - b) for a, b in zip(gs, rs)), default=0.0)
    check(err <= tol, f"{name}: scores differ by {err}")
    ident = [(r["source_sha1"], r["page"]) for r in got], [(r["source_sha1"], r["page"])
                                                         for r in ref]
    reordered, i = 0, 0
    while i < len(rs):
        j = i + 1
        while j < len(rs) and abs(rs[j] - rs[j - 1]) <= 2 * tol:
            j += 1
        if j < len(rs):
            check(set(ident[0][i:j]) == set(ident[1][i:j]),
                  f"{name}: pages differ at ranks {i}..{j}")
        reordered |= ident[0][i:j] != ident[1][i:j]
        i = j
    by_page = dict(zip(ident[1], ref))
    for key, r in zip(ident[0], got):
        o = by_page.get(key)
        check(o is None or all(r[f] == o[f] for f in (
            "text", "source_year", "hit_count", "method_count")),
              f"{name}: fields of page {key} differ")
    return int(reordered)


def same_payload(name, got, ref, tol, where="$"):
    """Two JSON payloads: the same keys, types and strings, floats within
    ``tol`` (a reranked ``combined_score`` is rounded to 4 places: one
    rounding step apart is the outcome of a 1e-7 difference)."""
    if isinstance(ref, float) and isinstance(got, float):
        lim = tol + (1e-4 if where.endswith(".combined_score") else 0.0)
        check(abs(got - ref) <= lim, f"{name}: {where} differs: {got} vs {ref}")
        return
    check(type(got) is type(ref), f"{name}: {where} types differ: "
          f"{type(got).__name__} vs {type(ref).__name__}")
    if isinstance(ref, dict):
        check(got.keys() == ref.keys(), f"{name}: {where} keys differ: "
              f"{sorted(set(got) ^ set(ref))}")
        for k in ref:
            if k not in QA_VOLATILE:
                same_payload(name, got[k], ref[k], tol, f"{where}.{k}")
    elif isinstance(ref, list):
        check(len(got) == len(ref), f"{name}: {where} lengths differ")
        for i, (a, b) in enumerate(zip(got, ref)):
            same_payload(name, a, b, tol, f"{where}[{i}]")
    else:
        check(got == ref, f"{name}: {where} differs: {got!r} vs {ref!r}")


def same_ask(name, got, ref, tol, got_calls=None, ref_calls=None):
    """One question answered twice: the retrieval results tie-aware
    (:func:`same_hits`), then, unless a tie group was reordered (every
    later stage then sees the pages in another order), the whole payload
    and every prompt the stub received.  Returns 1 for a reordered tie."""
    if same_hits(name, got["initial_retrieval_results"],
                 ref["initial_retrieval_results"], tol):
        log(f"{name}: a tie group of the retrieval results is reordered; the "
            f"rest of this answer is not compared")
        return 1
    same_payload(name, got, ref, tol)
    if got_calls is not None:
        # the reranker scores its batches on a thread pool: a multiset
        key = [sorted((c["system"], c["user"]) for c in calls)
               for calls in (got_calls, ref_calls)]
        check(key[0] == key[1], f"{name}: the prompts differ")
    return 0


def http_call(url, path, payload=None, want_json=True):
    """One request to the QA server; a JSON reply that carries ``error``
    fails the phase (the server turns every exception into one)."""
    import urllib.request

    data = None if payload is None else json.dumps(payload, ensure_ascii=False).encode()
    req = urllib.request.Request(url + path, data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read()
    if not want_json:
        return body.decode()
    out = json.loads(body)
    check(not (isinstance(out, dict) and "error" in out),
          f"{path} {payload}: the server replied {str(out)[:300]}")
    return out


def phase8_qa(dev, model, ctx3, card):
    """The QA server on the card over phase 3's deployment corpus: the
    ``qwen`` preset (parent pages, LLM reranking of 30) with hybrid BM25,
    a scripted stub in the LLM's seat and the full-width encoder as the
    embedder.  (1) 16 questions answered by a processor on the card and by
    one on the CPU engine over the same index with the same embeddings;
    (2) the same over HTTP (``QAWebApp``), and 2 ``hybrid_expansion`` and 2
    ``ssg`` asks, against the direct calls; the page, the question bank,
    a cited page and the judge; (3) launches per serial ask; (4) 8
    concurrent asks through the micro-batcher against the serial ones, in
    one dispatch; (5) ms per ask, the processor's stages, asks/s serial
    and at 8 concurrent, the card's busy share over one ask."""
    import copy
    import dataclasses
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from rag_challenge_2_tpu_torch.retrieval import QueryEngine
    from rag_challenge_2_tpu_torch.serving import QAWebApp

    log("== phase 8: the QA server on the card")
    t_phase = time.perf_counter()
    eng, reqs = ctx3["eng"], ctx3["requests"]
    cache = {}

    def embed_once(texts):
        """The encoder's embeddings, computed once per text and shared by
        the card's and the CPU's processors."""
        new = [t for t in dict.fromkeys(texts) if t not in cache]
        if new:
            cache.update(zip(new, model.embed(new)))
        return np.stack([cache[t] for t in texts])

    gp, gstub = qa_processor(eng, embed_once)
    cp, cstub = qa_processor(QueryEngine(eng.index.to("cpu"), eng.meta), embed_once)
    schema = gp.config.schema
    asks = [(question, years) for question, _, years, _ in reqs]

    # (1) direct calls: the card against the CPU engine
    direct, tied = [], 0
    for i, (question, years) in enumerate(asks):
        got_ref = []
        for proc, stub in ((gp, gstub), (cp, cstub)):
            stub.calls.clear()
            ans = proc.get_answer_for_company(COMPANY, question, schema,
                                              selected_years=years)
            # a non-JSON value (a tensor, a numpy scalar) raises here
            got_ref.append((json.loads(json.dumps(ans, ensure_ascii=False)),
                            list(stub.calls)))
        (g, gc), (c, cc) = got_ref
        routed = {eng.meta.docs[d].sha1 for d in eng.routed_docs(COMPANY, "", years)}
        check(g["final_answer"] == 68.9 and g["references"] and g["relevant_pages"]
              and all(r["source_sha1"] in routed and np.isfinite(r["distance"])
                      for r in g["initial_retrieval_results"]),
              f"ask {i}: no answer, or a hit outside the route")
        tied += same_ask(f"direct ask {i} (card vs CPU)", g, c, K1_TOL, gc, cc)
        direct.append(g)
    check(tied <= 1, f"{tied} of {len(asks)} asks reordered a tie group")
    log(f"direct: {len(asks)} asks on the card == on the CPU engine (retrieval "
        f"tie-aware within {K1_TOL}; references, relevant pages, final answer, "
        f"every prompt and the whole payload equal); asks with a reordered tie: {tied}")

    # (2) over HTTP
    app = QAWebApp(gp, default_company=COMPANY)
    server = app.make_server(port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    gp8, _ = qa_processor(eng, embed_once, micro_batch=8)
    # a window long enough for 8 requests to gather: the batcher dispatches
    # as soon as the 8th arrives
    gp8.batcher.window_ms = 400.0
    server8 = QAWebApp(gp8, default_company=COMPANY).make_server(port=0)
    threading.Thread(target=server8.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_port}"
    url8 = f"http://127.0.0.1:{server8.server_port}"
    try:
        html = http_call(url, "/", want_json=False)
        check("金盘科技年报问答" in html and "hybrid_expansion" in html, "GET / is not the page")
        bank = http_call(url, "/api/bank")
        check(isinstance(bank, dict) and all(bank.values()), "the question bank is empty")
        served, tied = [], 0
        for i, ((question, years), d) in enumerate(zip(asks, direct)):
            r = http_call(url, "/api/ask", {"question": question, "years": years})
            tied += same_ask(f"HTTP ask {i}", r, d, K1_TOL)
            served.append(r)
        check(tied <= 1, f"HTTP: {tied} asks reordered a tie group")
        ref = direct[0]["references"][0]
        page = http_call(url, f"/api/page?doc={ref['pdf_sha1']}&page={ref['page_index']}")
        check(page["page"] == ref["page_index"] and page["text"], "/api/page: no page text")
        judged = http_call(url, "/api/eval", {"records": [
            {"question": asks[0][0], "standard_answer": "68.9",
             "rag_answer": str(served[0]["final_answer"])}]})
        check(judged["statistics"]["accuracy"] == 1.0, f"/api/eval: {judged['statistics']}")
        for method in ("hybrid_expansion", "ssg"):
            proc = copy.copy(gp)
            proc.config = dataclasses.replace(gp.config, retrieval_method=method)
            for i, (question, years) in enumerate(asks[:2]):
                d = json.loads(json.dumps(proc.get_answer_for_company(
                    COMPANY, question, schema, selected_years=years), ensure_ascii=False))
                r = http_call(url, "/api/ask", {"question": question, "years": years,
                                                "method": method})
                check(r["retrieval_details"]["method"] == method,
                      f"HTTP {method}: no traversal details")
                check(not same_ask(f"HTTP {method} ask {i}", r, d, K1_TOL),
                      f"HTTP {method} ask {i}: a tie group reordered on one card")
        log(f"HTTP: GET /, /api/bank, /api/page, POST /api/eval answered; {len(asks)} "
            f"basic + BM25 asks == the direct calls (asks with a reordered tie: {tied}); "
            f"2 hybrid_expansion and 2 ssg asks == the direct calls; no reply carries error")

        # (3) launches per serial ask
        expected = {"basic": dict(dense_topk=3, span_gather=1, stream_topk=0),
                    "hybrid_expansion": dict(dense_topk=3, span_gather=1, stream_topk=36),
                    "ssg": dict(dense_topk=15, span_gather=1, stream_topk=0)}
        launches = {}
        for method, want in expected.items():
            for question, years in asks[:2]:
                zero_counts()
                http_call(url, "/api/ask", {"question": question, "years": years,
                                            "method": method})
                got = read_counts()
                check(all(got[k] == v for k, v in want.items()) and got["probe_scores"] == 0,
                      f"phase 8 launches of one {method} ask: {got}, expected {want}")
            launches[method] = {k: got[k] for k in want}
        log(f"launches per serial ask: {launches}")

        # (4) 8 concurrent asks through the micro-batcher, one route
        years0 = asks[0][1]
        same_route = ([i for i, (_, y) in enumerate(asks) if y == years0] * 8)[:8]

        def burst(u, idx):
            with ThreadPoolExecutor(len(idx)) as ex:
                return list(ex.map(lambda i: http_call(
                    u, "/api/ask", {"question": asks[i][0], "years": asks[i][1]}), idx))

        zero_counts()
        conc = burst(url8, same_route)
        got = read_counts()
        stats = dict(gp8.batcher.stats)
        check(stats["dispatches"] == 1 and stats["batched_requests"] == 8,
              f"8 concurrent asks: batcher {stats}, expected one dispatch of 8")
        check(got["dense_topk"] == 3 and got["stream_topk"] == 0,
              f"8 stacked asks (64 queries a slot) launch K1 once a slot: {got}")
        tied = sum(same_ask(f"concurrent ask {n}", r, served[i], K1_TOL)
                   for n, (i, r) in enumerate(zip(same_route, conc)))
        check(tied <= 1, f"concurrent: {tied} asks reordered a tie group")
        log(f"8 concurrent asks == the serial ones; the batcher ran one dispatch of 8 "
            f"requests (64 stacked queries a slot, {got['dense_topk']} K1 launches)")

        # (5) times with the encoder in the loop (no cache)
        gp.embedder = gp8.embedder = model.embed
        ask_ms, stage = [], {}
        t0 = time.perf_counter()
        for question, years in asks:
            t1 = time.perf_counter()
            r = http_call(url, "/api/ask", {"question": question, "years": years})
            ask_ms.append((time.perf_counter() - t1) * 1e3)
            for k, v in r["timing"].items():
                stage.setdefault(k, []).append(v * 1e3)
        serial_s = time.perf_counter() - t0
        stage_ms = {k: statistics.mean(v) for k, v in stage.items()}
        rates = {}
        for label, u in (("8 concurrent", url), ("8 concurrent, micro_batch 8", url8)):
            burst(u, same_route)                                   # warm-up
            _, t = wall(lambda: burst(u, same_route), dev)
            rates[label] = 8 / t
        payload = {"question": asks[0][0], "years": asks[0][1]}
        wall_ms, device_ms = busy_share(lambda: app.ask(dict(payload)))
    finally:
        for s in (server, server8):
            s.shutdown()
            s.server_close()
    out = dict(
        ms_per_ask_median=statistics.median(ask_ms), ms_per_ask_mean=statistics.mean(ask_ms),
        asks_per_s_serial=len(asks) / serial_s, asks_per_s=rates, stage_ms=stage_ms,
        busy=dict(wall_ms=wall_ms, device_ms=device_ms,
                  share=device_ms / wall_ms if device_ms else None),
        launches=launches, seconds=time.perf_counter() - t_phase)
    log(f"QA over HTTP on {card}: {len(asks)} serial asks, median "
        f"{out['ms_per_ask_median']:.2f} ms (mean {out['ms_per_ask_mean']:.2f}) = "
        f"{out['asks_per_s_serial']:.1f} asks/s; 8 concurrent "
        f"{rates['8 concurrent']:.1f} asks/s, with micro_batch 8 (400 ms window) "
        f"{rates['8 concurrent, micro_batch 8']:.1f} asks/s")
    log(f"QA stages on {card}, ms per ask: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()))
    log(f"one ask (QAWebApp.ask) under the profiler on {card}: wall {wall_ms:.2f} ms, "
        + (f"device kernels {device_ms:.2f} ms = {100 * device_ms / wall_ms:.1f}% busy"
           if device_ms else "no device records in the window: busy share not measured"))
    log(f"phase 8 took {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- phase 9

PIPE_PAGES = 480            # pages a synthetic report: ~1,700 chunks of ~310 chars
PIPE_TXT_YEARS = (2020, 2021, 2022, 2023, 2024)
PIPE_PDF_YEAR = 2025        # the sixth report goes through write_pdf → minipdf
PIPE_ADD_YEAR = 2019        # 9c's seventh report
# what the JAX package's run_e2e gives on the CPU over the same fixture:
# tests/test_torch_e2e.py::test_run_e2e_matches_jax holds the port to it
# per question (a narrow encoder on shared weights) and asserts these
JAX_E2E_CPU = {"value_accuracy": 1.0, "page_hit": 1.0, "n": 17}
CLI_TOL = 1e-2              # scores of two independent encoders (card, CPU)


def synthetic_pages(rng, year, n_pages=PIPE_PAGES, paras=6):
    """One synthetic annual report: pages of paragraphs from phase 3's
    templates, each page headed by its number."""
    pages = []
    for p in range(n_pages):
        body = []
        for _ in range(paras):
            body.append("".join(
                TEMPLATES[int(rng.integers(len(TEMPLATES)))].format(
                    y=year, m=METRICS[int(rng.integers(len(METRICS)))],
                    s=SEGMENTS[int(rng.integers(len(SEGMENTS)))],
                    v=float(rng.uniform(0.1, 90)), p=float(rng.uniform(0.1, 60)),
                    d="增长" if rng.random() < 0.7 else "下降",
                    q=int(rng.integers(1, 5)))
                for _ in range(int(rng.integers(4, 8)))))
        pages.append(f"{COMPANY}{year}年年度报告 第{p + 1}页\n\n" + "\n\n".join(body))
    return pages


def write_pipeline_root(root, rng, n_pages=PIPE_PAGES, n_questions=16):
    """The data-set layout of BASELINE configs 1-2 at the deployment size:
    five reports as ``.txt`` (form-feed page breaks) and one as a PDF,
    ``subset.csv`` and ``questions.json``."""
    from rag_challenge_2_tpu_torch.eval.e2e import write_pdf

    (root / "pdf_reports").mkdir(parents=True)
    rows = ["sha1,company_name,year"]
    for year in PIPE_TXT_YEARS + (PIPE_PDF_YEAR,):
        pages = synthetic_pages(rng, year, n_pages)
        sha = f"J{year}_jinpan"
        if year == PIPE_PDF_YEAR:
            (root / "pdf_reports" / f"{sha}.pdf").write_bytes(write_pdf(pages))
        else:
            (root / "pdf_reports" / f"{sha}.txt").write_text("\f".join(pages),
                                                             encoding="utf-8")
        rows.append(f"{sha},{COMPANY},{year}")
    (root / "subset.csv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    questions = [{"question": f"{COMPANY}{2021 + i % 4}年"
                              f"{METRICS[int(rng.integers(len(METRICS)))]}是多少？",
                  "schema": "number"} for i in range(n_questions)]
    (root / "questions.json").write_text(json.dumps(questions, ensure_ascii=False),
                                         encoding="utf-8")
    return questions


class EmbedOnce:
    """The encoder's embeddings, computed once per text on the card and
    shared with the CPU's pipeline (the CPU encoder is held to the card's
    on a sample instead: full width on the host is too slow for 10,200
    chunks).  Counts the texts it embedded and the seconds it took."""

    def __init__(self, model, dev):
        self.model, self.dev = model, dev
        self.rows, self.texts, self.seconds = {}, 0, 0.0

    def __call__(self, texts):
        import numpy as np

        new = [t for t in dict.fromkeys(texts) if t not in self.rows]
        if new:
            out, t = wall(lambda: self.model.embed(new), self.dev)
            self.rows.update(zip(new, out))
            self.texts += len(new)
            self.seconds += t
        return np.stack([self.rows[t] for t in texts])

    def cached(self, texts):
        """The CPU's side: only texts the card embedded (KeyError else)."""
        import numpy as np

        return np.stack([self.rows[t] for t in texts])


# the places the pipeline's path looks each kernel wrapper up at call time
_KERNEL_SEATS = (
    ("dense_topk", "rag_challenge_2_tpu_torch.ops.dense_topk", "dense_topk_fused"),
    ("stream_topk", "rag_challenge_2_tpu_torch.ops.stream_topk", "stream_topk"),
    ("span_gather", "rag_challenge_2_tpu_torch.ops.bm25", "gather_posting_spans"),
    ("span_gather", "rag_challenge_2_tpu_torch.index.ivf", "gather_posting_spans"),
    ("probe_scores", "rag_challenge_2_tpu_torch.index.ivf", "probe_span_scores"),
)


class FirstCalls:
    """Records each kernel wrapper's first call (its arguments) while the
    pipeline runs, so that the kernel is held against its plain version at
    the shapes this path gives it.  Read the launch counts after leaving
    the block: inside it the modules hold the recorders.  A wrapper counts
    its launches through its own module's global name, so where the seat
    is that module the recorder carries the counters and hands them back
    on exit."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        import importlib

        self.saved = []
        for name, mod_name, attr in _KERNEL_SEATS:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, attr)
            home = real.__module__ == mod.__name__

            def rec(*a, _real=real, _name=name, **kw):
                self.calls.setdefault(_name, (a, kw))
                return _real(*a, **kw)

            if home:
                rec.__dict__.update(real.__dict__)      # launches, K3's regime dict
            self.saved.append((mod, attr, real, rec if home else None))
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, real, rec in self.saved:
            if rec is not None:
                real.launches = rec.launches
            setattr(mod, attr, real)
        return False


def check_first_calls(where, calls):
    """Each recorded kernel call against its plain version: K1 and K3's
    float forms within 1e-4 (rows equal where untied), K3's int8 forms, K2
    and K4's int8 form bitwise.  Returns the max abs error by kernel."""
    import torch

    from rag_challenge_2_tpu_torch.ops.span_gather import (
        gather_posting_spans, gather_posting_spans_plain)

    errs = {}
    for name, (a, kw) in calls.items():
        if name == "dense_topk":
            errs[name] = compare_k1(where, *a, **kw)[0]
        elif name == "stream_topk":
            errs[name] = compare_k3(where, *a, exact=a[1].dtype == torch.int8, **kw)[0]
        elif name == "probe_scores":
            errs[name] = compare_k4(where, *a, kw["window"])
        else:
            got = gather_posting_spans(*a, **kw)
            ref = gather_posting_spans_plain(*a, **kw)
            check(all(torch.equal(g, r) for g, r in zip(got, ref)),
                  f"K2 {where}: not bitwise equal to plain")
            errs[name] = 0.0
    return errs


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cli_chain(device, root, env):
    """The README's sequence through the port's command line in
    subprocesses: parse-pdfs → process-reports → query (with BM25) →
    process-questions --config offline → serve --config offline with two
    asks over HTTP (the wide route's ``query --top-n 100`` is phase 9e's).  Returns what each
    printed or answered."""
    import os
    import signal

    def run(*args):
        out = subprocess.run(
            [sys.executable, "-m", "rag_challenge_2_tpu_torch", *args, "--root", str(root),
             "--device", device], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        check(out.returncode == 0, f"CLI {args[0]} on {device}: {out.stderr[-2000:]}")
        return out.stdout

    res = {}
    for stage in ("parse-pdfs", "process-reports"):
        t0 = time.perf_counter()
        run(stage)
        res[stage] = time.perf_counter() - t0
    q = ("--company", COMPANY, "--question", f"{COMPANY}2024年营业收入是多少？")
    res["query"] = run("query", *q, "--use-bm25")
    res["stats"] = json.loads(run("process-questions", "--config", "offline")
                              .strip().splitlines()[-1])
    res["answers"] = json.loads((root / "answers_offline_01.json").read_text("utf-8"))
    port = _free_port()
    server = subprocess.Popen(
        [sys.executable, "-m", "rag_challenge_2_tpu_torch", "serve", "--root", str(root),
         "--config", "offline", "--port", str(port), "--device", device],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        line = ""
        while "listening" not in line:
            line = server.stdout.readline()
            if not line and server.poll() is not None:
                raise SmokeError(f"serve on {device} ended: {server.stderr.read()[-2000:]}")
        url = f"http://127.0.0.1:{port}"
        res["asks"] = [http_call(url, "/api/ask", {"question": question})
                       for question in (f"{COMPANY}2024年营业收入是多少？",
                                        f"{COMPANY}2023年研发费用是多少？")]
    finally:
        os.killpg(server.pid, signal.SIGKILL)
        server.wait(timeout=30)
        server.stdout.close()
        server.stderr.close()
    return res


QUERY_LINE = re.compile(r"^\[(-?[0-9.]+)\] (\S+) p(\d+) hits=(\d+) methods=(\d+): ")


def same_query_lines(name, got, ref, tol):
    """Two ``query`` printouts: scores within ``tol`` rank by rank, the
    (document, page, hits, methods) identical up to the order inside groups
    of scores tied within ``tol``."""
    parse = [[m.groups() for m in map(QUERY_LINE.match, out.splitlines()) if m]
             for out in (got, ref)]
    check(parse[0] and len(parse[0]) == len(parse[1]),
          f"{name}: {len(parse[0])} hits against {len(parse[1])}")
    gs, rs = ([float(g[0]) for g in p] for p in parse)
    err = max(abs(a - b) for a, b in zip(gs, rs))
    check(err <= tol, f"{name}: scores differ by {err}")
    i = 0
    while i < len(rs):
        j = i + 1
        while j < len(rs) and abs(rs[j] - rs[j - 1]) <= 2 * tol:
            j += 1
        if j < len(rs):
            check(sorted(g[1:] for g in parse[0][i:j]) == sorted(r[1:] for r in parse[1][i:j]),
                  f"{name}: hits differ at ranks {i}..{j}")
        i = j
    return len(rs), err


def same_submissions(name, got, ref):
    """Two submission files: every answer's value and references equal."""
    ga, ra = got["answers"], ref["answers"]
    check(len(ga) == len(ra) and len(ga) > 0, f"{name}: {len(ga)} answers vs {len(ra)}")
    for a, b in zip(ga, ra):
        key = [(x["value"], [(r["pdf_sha1"], r["page_index"]) for r in x["references"]])
               for x in (a, b)]
        check(key[0] == key[1], f"{name}: {a['question_text']}: {key[0]} vs {key[1]}")


def phase9a_cli(work, card="cuda"):
    """The port's command line on two copies of ``data/test_set``, one
    driven with ``--device cuda`` (``card``) and one with ``--device cpu``
    (in parallel: the CPU chain never touches the card)."""
    import os
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    log("== phase 9a: the CLI on data/test_set, --device cuda and --device cpu")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT), RAGTPU_AUTO_PRETRAIN="0")
    roots, devices = {}, {"cuda": card, "cpu": "cpu"}
    for label in devices:
        roots[label] = work / f"cli_{label}"
        shutil.rmtree(roots[label], ignore_errors=True)
        shutil.copytree(ROOT / "data" / "test_set", roots[label])
    with ThreadPoolExecutor(2) as ex:
        futs = {d: ex.submit(cli_chain, devices[d], roots[d], env) for d in roots}
        res = {d: f.result() for d, f in futs.items()}
    g, c = res["cuda"], res["cpu"]
    for sub in ("debug_data/01_parsed_reports", "debug_data/02_merged_reports",
                "databases/chunked_reports"):
        for f in sorted((roots["cpu"] / sub).iterdir()):
            check((roots["cuda"] / sub / f.name).read_bytes() == f.read_bytes(),
                  f"{sub}/{f.name} differs between the two runs")
    n5, e5 = same_query_lines("query", g["query"], c["query"], CLI_TOL)
    check(g["stats"] == c["stats"] and g["stats"]["error_count"] == 0,
          f"process-questions: {g['stats']} vs {c['stats']}")
    same_submissions("process-questions answers", g["answers"], c["answers"])
    for i, (a, b) in enumerate(zip(g["asks"], c["asks"])):
        key = [(x["final_answer"], [(r["pdf_sha1"], r["page_index"]) for r in x["references"]])
               for x in (a, b)]
        check(key[0] == key[1], f"serve ask {i}: {key[0]} vs {key[1]}")
    out = dict(seconds=time.perf_counter() - t0, query_hits=n5,
               query_err=e5, stats=g["stats"],
               stage_s={d: {k: res[d][k] for k in ("parse-pdfs", "process-reports")}
                        for d in res})
    log(f"CLI: parse-pdfs, process-reports, query ({n5} hits, scores within "
        f"{out['query_err']:.2e} of the CPU's), process-questions "
        f"({g['stats']}), serve + 2 asks: --device cuda == --device cpu "
        f"(stage seconds {out['stage_s']}); phase 9a took {out['seconds']:.1f} s")
    return out


def pipeline_presets():
    import dataclasses

    from rag_challenge_2_tpu_torch.pipeline import configs

    serial = dict(parallel_requests=1)          # the launch counters are unlocked
    return {
        # BASELINE configs 1-2: the served hybrid (K1 + K2)
        "offline+bm25": dataclasses.replace(configs["offline"], use_bm25_db=True, **serial),
        # the int8 flat store (K3's int8 form + K2)
        "offline+bm25+int8": dataclasses.replace(configs["offline"], use_bm25_db=True,
                                                 quantize_int8=True, **serial),
        # the scale10m preset's flags: IVF probes over the cluster-ordered
        # int8 store (K4 + K2)
        "scale10m": dataclasses.replace(configs["scale10m"], **serial),
    }


def phase9b_pipeline(dev, model, work, rng, n_pages=PIPE_PAGES):
    """BASELINE configs 1-2 through ``Pipeline`` at the deployment size:
    every stage on the card, timed; three presets answer 16 questions each,
    every answer held against a ``Pipeline`` on the CPU over the same root
    (the same embeddings), each kernel's first call on this path held
    against its plain version, launches per question counted."""
    import shutil

    import numpy as np
    import torch

    from rag_challenge_2_tpu_torch.eval.e2e import ExtractiveStubProvider
    from rag_challenge_2_tpu_torch.index import load_index
    from rag_challenge_2_tpu_torch.index.build import load_chunked_reports
    from rag_challenge_2_tpu_torch.ingestion import CorpusIngestor
    from rag_challenge_2_tpu_torch.models.encoder import EmbeddingModel
    from rag_challenge_2_tpu_torch.pipeline import Pipeline

    log("== phase 9b: the pipeline at the deployment's size (Pipeline, BASELINE configs 1-2)")
    t_phase = time.perf_counter()
    root = work / "pipeline"
    shutil.rmtree(root, ignore_errors=True)
    questions = write_pipeline_root(root, rng, n_pages)
    embed = EmbedOnce(model, dev)
    presets = pipeline_presets()
    pipe = Pipeline(root, presets["offline+bm25"], embedder=embed,
                    provider=ExtractiveStubProvider(), device=dev)
    stage_s = {}
    for stage in ("parse_pdf_reports", "merge_reports", "chunk_reports"):
        _, stage_s[stage] = wall(getattr(pipe, stage), dev)
    reports = load_chunked_reports(pipe.paths.documents_dir)
    n_chunks = sum(len(r["content"]["chunks"]) for r in reports)
    pdf_pages = len(next(r for r in reports if r["metainfo"]["sha1_name"]
                         == f"J{PIPE_PDF_YEAR}_jinpan")["content"]["pages"])
    check(pdf_pages == n_pages, f"minipdf: {pdf_pages} pages of {n_pages}")
    wall_ms, dev_ms = busy_share(pipe.create_vector_dbs)
    stage_s["create_vector_dbs"] = wall_ms / 1e3
    busy = {"create_vector_dbs": dev_ms / wall_ms if dev_ms else None}
    embed_rate = embed.texts / embed.seconds
    log(f"{len(reports)} reports ({n_pages} pages each, one a PDF), {n_chunks} chunks; "
        f"embedded {embed.texts} texts in {embed.seconds:.2f} s = {embed_rate:.0f} chunks/s "
        f"(full-width encoder)")

    # the CPU's index from the same chunks and embeddings: CSR and columns
    # bitwise, rows bitwise (one embedding per text)
    idx, meta = load_index(pipe.paths.index_path, device=dev)
    ref, ref_meta = CorpusIngestor(embed.cached, device="cpu").build(reports)
    for name in ("emb", "doc_id", "page", "year", "company_id", "kind", "page_seg",
                 "chunk_in_doc", "valid"):
        check(torch.equal(getattr(idx, name).cpu(), getattr(ref, name)),
              f"the card's index differs from the CPU's in {name}")
    for name in ("indptr", "chunk_ids", "tf", "df", "chunk_len", "dl"):
        check(torch.equal(getattr(idx.sparse, name).cpu(), getattr(ref.sparse, name)),
              f"the card's CSR differs from the CPU's in {name}")
    check(meta.chunk_texts == ref_meta.chunk_texts and meta.companies == ref_meta.companies,
          "the index's metadata differs from the CPU's")
    # the encoder itself, card against CPU, on a sample of chunks
    sample = meta.chunk_texts[:: max(1, n_chunks // 12)][:12]
    cpu_model = EmbeddingModel(model.cfg, params=model.module.state_dict(), device="cpu")
    a, b = model.embed(sample), cpu_model.embed(sample)
    cos = float(((a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min())
    enc_err = float(np.abs(a - b).max())
    check(cos >= 0.999 and enc_err <= 0.02,
          f"the encoder on the card against the CPU: cos {cos}, max diff {enc_err}")
    log(f"the card's index == the CPU's (CSR, columns and rows bitwise, n_pad {idx.n_pad}, "
        f"nnz_pad {idx.sparse.chunk_ids.shape[0]}); the encoder on {len(sample)} chunks: "
        f"cos >= {cos:.6f}, max |diff| {enc_err:.2e} against the CPU")
    del idx, ref

    out = dict(chunks=n_chunks, reports=len(reports), pdf_pages=pdf_pages,
               embed_chunks_s=embed_rate, presets={})
    launches_total = dict.fromkeys(("dense_topk", "span_gather", "stream_topk",
                                    "probe_scores"), 0)
    errs, seen_kernels = {}, {}
    for name, rc in presets.items():
        gp = Pipeline(root, rc, embedder=embed, provider=ExtractiveStubProvider(),
                      device=dev)
        proc, t_build = wall(gp.build_processor, dev)
        payloads = {}
        real = proc.process_question

        def recorded(text, schema, _real=real, _out=payloads):
            _out[text] = _real(text, schema)
            return _out[text]

        proc.process_question = recorded
        gp.build_processor = lambda _p=proc: _p
        zero_counts()
        with FirstCalls() as first:
            result, t_q = wall(gp.process_questions, dev)
        counts = read_counts()
        failed = [d for d in result["answer_details"] if d and "error_traceback" in d]
        check(not failed, f"{name}: {result['statistics']}; the first error: "
              + (failed[0]["error_traceback"][-3000:] if failed else ""))
        errs.update({f"{name} {k}": v for k, v in
                     check_first_calls(f"{name} (pipeline)", first.calls).items()})
        seen_kernels.update(first.calls)
        payloads_once = dict(payloads)
        w_ms, d_ms = busy_share(lambda: proc.process_question(
            questions[0]["question"], questions[0]["schema"]))
        # the CPU's pipeline over the same root and embeddings
        cp = Pipeline(root, rc, embedder=embed.cached, provider=ExtractiveStubProvider(),
                      device="cpu")
        cproc = cp.build_processor()
        tied = sum(same_ask(f"{name}: {q['question']}",
                            json.loads(json.dumps(payloads_once[q["question"]],
                                                  ensure_ascii=False)),
                            json.loads(json.dumps(cproc.process_question(
                                q["question"], q["schema"]), ensure_ascii=False)),
                            K1_TOL)
                   for q in questions)
        check(tied <= 1, f"{name}: {tied} of {len(questions)} answers behind a reordered tie")
        per_q = {k: v / len(questions) for k, v in counts.items()}
        for k, v in counts.items():
            launches_total[k] += v
        out["presets"][name] = dict(
            build_processor_s=t_build, process_questions_s=t_q,
            ms_per_question=t_q / len(questions) * 1e3, launches_per_question=per_q,
            busy_one_question=d_ms / w_ms if d_ms else None, tied=tied,
            stats=result["statistics"])
        log(f"{name}: build_processor {t_build:.2f} s, process_questions "
            f"{t_q:.2f} s ({t_q / len(questions) * 1e3:.1f} ms a question), launches a "
            f"question {per_q}, busy over one question "
            + (f"{100 * d_ms / w_ms:.1f}%" if d_ms else "not measured")
            + f"; {len(questions)} answers == the CPU pipeline's (reordered ties: {tied}); "
            f"{result['statistics']}")
    missing = [k for k, v in launches_total.items() if v == 0 or k not in seen_kernels]
    check(not missing, f"phase 9b's pipeline path never launched {missing}")
    out.update(stage_s=stage_s, busy=busy, kernel_errs=errs,
               launches_per_question={k: v / len(questions) for k, v in launches_total.items()},
               seconds=time.perf_counter() - t_phase)
    busy["process_questions"] = out["presets"]["offline+bm25"]["busy_one_question"]
    log("stage wall times (s): " + ", ".join(f"{k} {v:.2f}" for k, v in stage_s.items())
        + "; card busy during create_vector_dbs "
        + (f"{100 * busy['create_vector_dbs']:.1f}%" if busy["create_vector_dbs"]
           else "not measured"))
    log(f"kernels at phase 9b's shapes against plain: {errs}; phase 9b took "
        f"{out['seconds']:.1f} s")
    return out, dict(root=root, embed=embed, reports=reports, questions=questions)


def phase9c_add_reports(dev, ctx, rng, n_pages=PIPE_PAGES):
    """BASELINE config 4: ``CorpusIngestor.add_reports`` of a seventh report
    (parsed, merged and chunked by the pipeline's host stages) into 9b's
    index on the card, held against a fresh build of all seven: columns,
    CSR and metadata equal, rows bitwise; then the same into the int8
    variant of the index (the dequantized path)."""
    import dataclasses

    import torch

    from rag_challenge_2_tpu_torch.index import load_index, quantize_index
    from rag_challenge_2_tpu_torch.ingestion import (
        CorpusIngestor, PageTextPreparation, PlainTextParser, TextSplitter)

    log("== phase 9c: incremental ingest (add_reports, BASELINE config 4)")
    t0 = time.perf_counter()
    side = ctx["root"] / "added"
    (side / "in").mkdir(parents=True)
    sha = f"J{PIPE_ADD_YEAR}_jinpan"
    (side / "in" / f"{sha}.txt").write_text("\f".join(synthetic_pages(
        rng, PIPE_ADD_YEAR, n_pages)), encoding="utf-8")
    (side / "subset.csv").write_text(f"sha1,company_name,year\n{sha},{COMPANY},"
                                     f"{PIPE_ADD_YEAR}\n", encoding="utf-8")
    PlainTextParser(side / "parsed", side / "subset.csv").parse_and_export(
        [side / "in" / f"{sha}.txt"])
    PageTextPreparation().process_reports(side / "parsed", side / "merged")
    TextSplitter().split_all_reports(side / "merged", side / "chunked")
    new = json.loads((side / "chunked" / f"{sha}.json").read_text("utf-8"))
    n_new = len(new["content"]["chunks"])
    embed = ctx["embed"]
    ing = CorpusIngestor(embed, device=dev)
    idx, meta = load_index(ctx["root"] / "databases" / "corpus_index.npz", device=dev)
    before = (embed.texts, embed.seconds)
    (got, got_meta), t_add = wall(lambda: ing.add_reports(idx, meta, [new]), dev)
    added = embed.texts - before[0]
    rate = added / (embed.seconds - before[1])
    check(added == len(set(c["text"] for c in new["content"]["chunks"])),
          f"add_reports embedded {added} texts for {n_new} new chunks")
    fresh, fresh_meta = ing.build(ctx["reports"] + [new])
    cols = ("emb", "doc_id", "page", "year", "company_id", "kind", "page_seg",
            "chunk_in_doc", "valid")
    for name in cols:
        check(torch.equal(getattr(got, name), getattr(fresh, name)),
              f"add_reports: {name} differs from a fresh build")
    for name in ("indptr", "chunk_ids", "tf", "df", "chunk_len", "dl"):
        check(torch.equal(getattr(got.sparse, name), getattr(fresh.sparse, name)),
              f"add_reports: CSR {name} differs from a fresh build")
    check(dataclasses.asdict(got_meta) == dataclasses.asdict(fresh_meta),
          "add_reports: metadata differs from a fresh build")
    q8 = quantize_index(idx)
    (got8, got8_meta), t_add8 = wall(lambda: ing.add_reports(q8, meta, [new]), dev)
    n_old = idx.n_chunks
    deq = q8.emb[:n_old].float() * q8.emb_scale[:n_old, None]
    check(torch.equal(got8.emb[:n_old], deq) and torch.equal(got8.emb[n_old:], fresh.emb[n_old:]),
          "add_reports on the int8 index: rows are not the dequantized old + the new")
    for name in cols[1:]:
        check(torch.equal(getattr(got8, name), getattr(fresh, name)),
              f"add_reports on the int8 index: {name} differs from a fresh build")
    check(torch.equal(got8.sparse.chunk_ids, fresh.sparse.chunk_ids)
          and dataclasses.asdict(got8_meta) == dataclasses.asdict(fresh_meta),
          "add_reports on the int8 index: CSR or metadata differs")
    out = dict(n_old=n_old, n_new=n_new, add_s=t_add, add_int8_s=t_add8,
               embed_chunks_s=rate, seconds=time.perf_counter() - t0)
    log(f"add_reports: {n_new} new chunks into {n_old} on the card in {t_add:.2f} s "
        f"(embedding {rate:.0f} chunks/s; int8 index {t_add8:.2f} s) == a fresh build of "
        f"all seven reports (columns, CSR, metadata; f32 rows bitwise, int8: the "
        f"dequantized old rows + the new); phase 9c took {out['seconds']:.1f} s")
    return out


def phase9d_e2e(dev, work):
    """The end-to-end eval on the card: ``run_e2e`` over the 17 golden
    questions of the PDF fixture, against the same run on the CPU."""
    import shutil

    from rag_challenge_2_tpu_torch.eval.e2e import run_e2e

    log("== phase 9d: the end-to-end eval (run_e2e, 17 golden questions)")
    runs = {}
    for label, device in (("cuda", dev), ("cpu", "cpu")):
        root = work / f"e2e_{label}"
        shutil.rmtree(root, ignore_errors=True)
        runs[label], t = wall(lambda: run_e2e(root, device=device), dev)
        runs[label]["seconds"] = t
    g, c = runs["cuda"], runs["cpu"]
    for a, b in zip(g["per_question"], c["per_question"]):
        check(a == b, f"run_e2e: the card and the CPU differ: {a} vs {b}")
    check(g["n"] == 17 and g["value_accuracy"] >= 0.9 and g["page_hit"] >= 0.9,
          f"run_e2e on the card: {g['value_accuracy']} / {g['page_hit']}")
    log(f"run_e2e on the card: value_accuracy {g['value_accuracy']}, page_hit "
        f"{g['page_hit']}, n {g['n']} in {g['seconds']:.2f} s; == the CPU's per question "
        f"({c['seconds']:.2f} s); the JAX package on the CPU (tests/test_torch_e2e.py): "
        f"{JAX_E2E_CPU}")
    return {d: {k: r[k] for k in ("value_accuracy", "page_hit", "n", "seconds")}
            for d, r in runs.items()}


def phase9e_wide(dev, ctx):
    """Wide k on the card: a traversal ask with ``neighbor_k = 100`` (101
    candidates a hop, above K1's and K3's 64) and ``query --top-n 100``
    over 9b's index, against the CPU, tie-aware; the route is counted."""
    import dataclasses

    from rag_challenge_2_tpu_torch import cli
    from rag_challenge_2_tpu_torch.eval.e2e import ExtractiveStubProvider
    from rag_challenge_2_tpu_torch.ops.topk import wide_topk
    from rag_challenge_2_tpu_torch.pipeline import Pipeline
    from rag_challenge_2_tpu_torch.serving import QAWebApp

    log("== phase 9e: wide k on the card (neighbor_k = 100, top-n 100)")
    rc = pipeline_presets()["offline+bm25"]
    apps = {}
    for label, device, embed in (("cuda", dev, ctx["embed"]),
                                 ("cpu", "cpu", ctx["embed"].cached)):
        p = Pipeline(ctx["root"], dataclasses.replace(rc), embedder=embed,
                     provider=ExtractiveStubProvider(), device=device)
        apps[label] = QAWebApp(p.build_processor(), default_company=COMPANY)
    out, tied = {}, 0
    for method in ("ssg", "hybrid_expansion"):
        for q in ctx["questions"][:2]:
            payload = {"question": q["question"], "method": method, "neighbor_k": 100}
            zero_counts()
            w0 = wide_topk.launches
            g = apps["cuda"].ask(dict(payload))
            counts, wide = read_counts(), wide_topk.launches - w0
            check("error" not in g, f"{method} neighbor_k 100 on the card: {g.get('error')}")
            check(wide > 0 and counts["stream_topk"] == 0,
                  f"{method} neighbor_k 100: wide {wide}, kernels {counts}")
            c = apps["cpu"].ask(dict(payload))
            tied += same_ask(f"{method} neighbor_k 100", json.loads(json.dumps(
                g, ensure_ascii=False)), json.loads(json.dumps(c, ensure_ascii=False)), K1_TOL)
            out[method] = dict(wide_launches=wide, kernel_launches=counts)
    check(tied <= 1, f"wide asks: {tied} reordered ties")
    args = ["query", "--root", str(ctx["root"]), "--company", COMPANY, "--question",
            ctx["questions"][0]["question"], "--use-bm25", "--top-n", "100"]
    w0 = wide_topk.launches
    lines_g = cli.query(cli.build_parser().parse_args(args + ["--device", dev.type]))
    out["query_100_wide_launches"] = wide_topk.launches - w0
    lines_c = cli.query(cli.build_parser().parse_args(args + ["--device", "cpu"]))
    # two encoders embed the question (card, CPU): CLI_TOL
    n, err = same_query_lines("query --top-n 100", "\n".join(lines_g), "\n".join(lines_c),
                              CLI_TOL)
    check(n == 100 and out["query_100_wide_launches"] > 0,
          f"query --top-n 100: {n} hits, {out['query_100_wide_launches']} wide calls")
    log(f"neighbor_k 100 asks (ssg, hybrid_expansion; 2 each) == the CPU's (reordered "
        f"ties: {tied}); wide_topk calls a question {dict((m, out[m]['wide_launches']) for m in ('ssg', 'hybrid_expansion'))}, "
        f"K3 none; query --top-n 100: {n} hits == the CPU's within {err:.2e}, "
        f"{out['query_100_wide_launches']} wide_topk calls")
    return out


def phase9_pipeline(dev, model, seed, work, n_pages=PIPE_PAGES):
    """Phase 9: the ingestion pipeline, the CLI, the end-to-end eval and
    wide k, on the card (9a-9e); returns 9b's corpus for phase 10."""
    import numpy as np

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 9)
    out = {"cli": phase9a_cli(work, dev.type)}
    out["pipeline"], ctx = phase9b_pipeline(dev, model, work, rng, n_pages)
    out["add_reports"] = phase9c_add_reports(dev, ctx, rng, n_pages)
    out["e2e"] = phase9d_e2e(dev, work)
    out["wide"] = phase9e_wide(dev, ctx)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 9 took {out['seconds']:.1f} s")
    return out, ctx


# --------------------------------------------------------------- phase 10

BF16_OPS_S = 989e12          # the H100 SXM's dense bf16 tensor-core peak
# the recorded quality eval (docs/ENCODER_QUALITY.json, seed 0 unless noted):
# quality numbers carry over between devices, times do not
QUALITY_RECORD = {"bm25": (0.905, 0.3801), "encoder_random_init": (0.305, 0.1396),
                  "encoder_ict": (0.0, 0.0024), "encoder_unsupervised": (0.18, 0.1051),
                  "encoder_bm25_distill": (0.47, 0.2068),
                  "encoder_alias_distill": (0.73, 0.363),
                  "hybrid_alias_distill": (0.905, 0.4404),
                  "encoder_bm25_listwise": (0.21, 0.1067),
                  "encoder_ict_supervised": (1.0, 1.0)}
SIGN_RULE = 1e-3             # Adam's first update ~ lr * sign(g): |g| under
                             # this share of a tensor's max is counted only


def train_step_ops(q, p, cfg):
    """Forward + backward operations of one contrastive step on these token
    batches, counting valid tokens only (padding changes no output): per
    token and block 8 d^2 (q, k, v, out) + 4 d d_ff (MLP), per sequence
    and block 4 n^2 d (scores and the weighted sum over n valid tokens),
    per sequence 2 d out_dim (the projection); the logits 2 B^2 out_dim;
    backward twice the forward."""
    d, ff = cfg.d_model, cfg.d_ff
    fwd = 0
    for tokens in (q, p):
        n = (tokens >= 0).sum(dim=1).double()
        fwd += cfg.n_layers * (float(n.sum()) * (8 * d * d + 4 * d * ff)
                               + float((n * n).sum()) * 4 * d)
        fwd += tokens.shape[0] * 2 * d * cfg.out_dim
    fwd += 2 * q.shape[0] * p.shape[0] * cfg.out_dim
    return 3 * fwd


def step_bound(q, p, cfg, n_params, peak):
    """The step's least time: its operations over the peak of its type, or
    its bytes (the tokens read, the f32 weights and AdamW's two moments read
    once and written once) over the HBM rate, the larger."""
    nbytes = 6 * 4 * n_params + 4 * (q.numel() + p.numel())
    return bound(nbytes, train_step_ops(q, p, cfg), peak)


def compare_steps(name, card, cpu, f32, gates=None):
    """One train step's results, card against CPU: loss, accuracy, the
    per-tensor gradient cosine, and the parameters after the step where
    the gradient's sign is sure (|g| >= SIGN_RULE x the tensor's max, or 0
    in both); the rest, and attention's key bias (its gradient is 0 in
    exact arithmetic), are counted.  f32: loss within 1e-4 relative, every
    cosine >= 0.9999, every compared parameter within 1e-6; bf16: loss
    within 2e-2, cosines >= 0.99, at most 0.1% of the compared parameters
    further than 1e-6 (a bf16 gradient's sign can flip at 1e-3 of its
    tensor's max).  ``gates`` = (loss relative, cosine, share of the compared
    parameters off) replaces those."""
    import torch

    loss_tol, cos_gate, off_share = gates or ((1e-4, 0.9999, 0.0) if f32 else
                                              (2e-2, 0.99, 1e-3))
    (gm, gmod), (cm, cmod) = card, cpu
    dl = abs(gm["loss"].item() - cm["loss"].item()) / abs(cm["loss"].item())
    check(dl <= loss_tol, f"{name}: loss {gm['loss'].item()} vs "
          f"{cm['loss'].item()}")
    cos_min, compared, counted, off = 1.0, 0, 0, 0
    for (n, gp), (_, cp) in zip(gmod.named_parameters(), cmod.named_parameters()):
        g, c = gp.grad.detach().cpu().double(), cp.grad.detach().double()
        top = c.abs().max()
        if n.endswith(".key.bias"):
            # 0 in exact arithmetic (the softmax ignores a shift shared by
            # all keys): rounding on both sides, so Adam moves it by
            # lr * the sign of noise; counted, never compared
            counted += c.numel()
            continue
        if top > 0:
            cos_min = min(cos_min, float((g.flatten() @ c.flatten())
                                         / (g.norm() * c.norm())))
        sure = (c.abs() >= SIGN_RULE * top) | ((c == 0) & (g == 0))
        diff = (gp.detach().cpu() - cp.detach()).abs()[sure]
        compared += int(sure.sum())
        counted += int((~sure).sum())
        off += int((diff > 1e-6).sum())
    check(cos_min >= cos_gate, f"{name}: gradient cosine {cos_min}")
    check(off <= off_share * compared,
          f"{name}: {off} of {compared} parameters differ after the step")
    return dict(loss=gm["loss"].item(), loss_cpu=cm["loss"].item(), loss_rel=dl,
                accuracy=gm["accuracy"].item(), accuracy_cpu=cm["accuracy"].item(),
                grad_cos_min=cos_min, params_compared=compared, params_counted=counted,
                params_off=off)


def top_kernels(fn, n=6):
    """The ``n`` device kernels with the most device time in one ``fn()``
    under ``torch.profiler``: ``[(name, ms, count), ...]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(ev.key[:60], device_us(ev) / 1e3, ev.count)
            for ev in prof.key_averages()]
    return sorted([r for r in rows if r[1] > 0], key=lambda r: -r[1])[:n]


def phase10a_step(dev, seed, texts):
    """One full-width train step on the card and on the CPU from the same
    weights and sampled batch (default EncoderConfig, max_len 64, batch
    64), in f32 and bf16 activations; the card's step timed by CUDA events
    beside its bound, its device kernels and busy share."""
    import dataclasses

    import numpy as np
    import torch

    from rag_challenge_2_tpu_torch.models.encoder import Encoder, EncoderConfig, tokenize_batch
    from rag_challenge_2_tpu_torch.models.pretrain import PairSampler, PretrainConfig
    from rag_challenge_2_tpu_torch.models.train import (
        TrainConfig, make_optimizer, make_train_step)
    from rag_challenge_2_tpu_torch.utils.timing import cuda_ms_train

    log("== phase 10a: one full-width train step, the card against the CPU")
    t0 = time.perf_counter()
    pre = PretrainConfig(seed=seed)
    qs, ps, _ = PairSampler(texts, pre, device=dev).sample(np.random.default_rng(seed))
    tc = TrainConfig(lr=3e-4)
    out = {}
    for dtype, peak in ((torch.float32, F32_OPS_S), (torch.bfloat16, BF16_OPS_S)):
        cfg = dataclasses.replace(EncoderConfig(), dtype=dtype)
        q = torch.from_numpy(tokenize_batch(qs, pre.max_len, cfg.vocab_bits))
        p = torch.from_numpy(tokenize_batch(ps, pre.max_len, cfg.vocab_bits))
        init = Encoder(cfg)
        init.init_weights(torch.Generator().manual_seed(seed))
        runs = {}
        for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
            mod = Encoder(cfg)
            mod.load_state_dict(init.state_dict())
            mod.to(where)
            step = make_train_step(mod, make_optimizer(mod.parameters(), tc), tc)
            runs[label] = (step(q.to(where), p.to(where)), mod, step)
        short = "f32" if dtype == torch.float32 else "bf16"
        res = compare_steps(f"10a {short}", runs["card"][:2], runs["cpu"][:2],
                            dtype == torch.float32)
        step, mod = runs["card"][2], runs["card"][1]
        qd, pd = q.to(dev), p.to(dev)
        ms = cuda_ms_train(lambda: step(qd, pd), n=10, reps=5)
        n_params = sum(t.numel() for t in mod.parameters())
        bnd = step_bound(q, p, cfg, n_params, peak)
        kernels, launches = profile_calls(lambda: step(qd, pd))
        w_ms, d_ms = busy_share(lambda: [step(qd, pd) for _ in range(10)])
        top = top_kernels(lambda: step(qd, pd))
        log(f"10a {short}: the step's top device kernels (name, ms, count): {top}")
        res.update(top_kernels=top, ms=ms, bound_ms=bnd[0], bound_by=bnd[1], params=n_params,
                   gflop=train_step_ops(q, p, cfg) / 1e9,
                   valid_tokens=int((q >= 0).sum() + (p >= 0).sum()),
                   device_kernels=len(kernels), launch_calls=launches,
                   busy=d_ms / w_ms if d_ms else None, ms_wall_10=w_ms / 10)
        out[short] = res
        log(f"10a {short}: loss {res['loss']:.5f} (CPU {res['loss_cpu']:.5f}), accuracy "
            f"{res['accuracy']:.4f} (CPU {res['accuracy_cpu']:.4f}), gradient cosine >= "
            f"{res['grad_cos_min']:.6f}, {res['params_compared']} parameters compared "
            f"after the step ({res['params_off']} off, {res['params_counted']} counted); "
            f"{n_params} parameters, {res['valid_tokens']} valid tokens, "
            f"{res['gflop']:.1f} GFLOP; step {share(ms, bnd)}; {len(kernels)} device "
            f"kernels a step; busy over 10 steps "
            + (f"{100 * res['busy']:.1f}%" if res["busy"] else "not measured")
            + f" ({res['ms_wall_10']:.2f} ms a step by the host's clock)")
    out["seconds"] = time.perf_counter() - t0
    return out


class Timed:
    """Wraps a module's function: records each call's wall seconds and
    result (the seat is restored on exit)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def rec(*a, **kw):
            t0 = time.perf_counter()
            out = self.real(*a, **kw)
            self.calls.append((time.perf_counter() - t0, out))
            return out

        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def loop_split(dev, texts, pre, steps=20):
    """The pretraining loop's time split over ``steps`` steps: the host's
    sampler + tokenizer per step (perf_counter), the train step on the
    card per step (CUDA events over back-to-back steps on pre-sampled
    batches), and the whole loop's busy share (``pretrain_encoder``)."""
    import numpy as np
    import torch

    from rag_challenge_2_tpu_torch.models.encoder import EncoderConfig, tokenize_batch
    from rag_challenge_2_tpu_torch.models.pretrain import PairSampler
    from rag_challenge_2_tpu_torch.models.train import TrainConfig, init_training
    from rag_challenge_2_tpu_torch.utils.timing import cuda_ms_train

    cfg = EncoderConfig()
    sampler = PairSampler(texts, pre, device=dev)
    rng = np.random.default_rng(pre.seed)
    t0 = time.perf_counter()
    batches = []
    for _ in range(steps):
        qs, ps, _ = sampler.sample(rng)
        batches.append((torch.from_numpy(tokenize_batch(qs, pre.max_len, cfg.vocab_bits)),
                        torch.from_numpy(tokenize_batch(ps, pre.max_len, cfg.vocab_bits))))
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    _, _, step = init_training(cfg, TrainConfig(lr=3e-4), dev)
    dev_batches = [(q.to(dev), p.to(dev)) for q, p in batches]
    it = iter(range(10 ** 9))
    step_ms = cuda_ms_train(lambda: step(*dev_batches[next(it) % steps]), n=steps, reps=3)
    def host(texts):
        t = torch.from_numpy(tokenize_batch(texts, pre.max_len, cfg.vocab_bits))
        return t.pin_memory() if dev.type == "cuda" else t

    def loop():
        # pretrain_encoder's loop body: sample, tokenize, pin, step
        for _ in range(steps):
            qs, ps, _ = sampler.sample(rng)
            step(host(qs), host(ps))

    w_ms, d_ms = busy_share(loop)
    return dict(sampler_ms=host_ms, step_ms=step_ms, loop_ms=w_ms / steps,
                busy=d_ms / w_ms if d_ms else None)


def phase10b_auto_pretrain(dev, ctx9, steps=300):
    """``Pipeline.create_vector_dbs`` on phase 9b's corpus with no saved
    params: the auto-pretrain (300 steps, default PretrainConfig, host
    teacher), the saved npz, the index; the ``offline`` + BM25 preset then
    answers 9b's 16 questions through K1 + K2 (against a CPU pipeline on
    the same embeddings); the npz through the CPU encoder against the
    card's; the loop's time split; ``eval_hybrid_e2e`` with the trained
    encoder (K1 + K2), card against CPU."""
    import os
    import numpy as np

    import rag_challenge_2_tpu_torch.models.pretrain as pretrain_mod
    from rag_challenge_2_tpu_torch.eval.e2e import ExtractiveStubProvider
    from rag_challenge_2_tpu_torch.eval.encoder_quality import eval_hybrid_e2e
    from rag_challenge_2_tpu_torch.index.build import load_chunked_reports
    from rag_challenge_2_tpu_torch.models.encoder import EmbeddingModel, EncoderConfig
    from rag_challenge_2_tpu_torch.models.pretrain import PretrainConfig, load_params
    from rag_challenge_2_tpu_torch.pipeline import Pipeline

    log("== phase 10b: the auto-pretrain through Pipeline.create_vector_dbs "
        "(phase 9b's corpus, no saved params)")
    t_phase = time.perf_counter()
    root = ctx9["root"]
    rc = pipeline_presets()["offline+bm25"]
    pipe = Pipeline(root, rc, provider=ExtractiveStubProvider(), device=dev)
    params = pipe.paths.databases_path / "encoder_params.npz"
    check(not params.exists(), f"{params} exists before the auto-pretrain")
    env = {k: os.environ.pop(k, None) for k in ("RAGTPU_AUTO_PRETRAIN",
                                                "RAGTPU_AUTO_PRETRAIN_STEPS")}
    os.environ["RAGTPU_AUTO_PRETRAIN_STEPS"] = str(steps)    # 300: the default
    try:
        with Timed(pretrain_mod, "pretrain_encoder") as pt:
            _, t_dbs = wall(pipe.create_vector_dbs, dev)
    finally:
        os.environ.pop("RAGTPU_AUTO_PRETRAIN_STEPS")
        os.environ.update({k: v for k, v in env.items() if v is not None})
    check(len(pt.calls) == 1 and params.exists() and pipe.paths.index_path.exists(),
          f"create_vector_dbs: {len(pt.calls)} pretrainings, params {params.exists()}")
    t_pre, (trained, info) = pt.calls[0]
    hist = info["history"]
    check(hist[-1]["step"] == steps - 1 and hist[-1]["loss"] < hist[0]["loss"],
          f"the auto-pretrain's loss did not fall: {hist}")
    texts = [c["text"] for r in load_chunked_reports(pipe.paths.documents_dir)
             for c in r["content"]["chunks"]]
    log(f"auto-pretrain: {steps} steps on {len(texts)} chunks in {t_pre:.2f} s = "
        f"{steps / t_pre:.1f} steps/s; loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
        f"accuracy {hist[0]['accuracy']:.4f} -> {hist[-1]['accuracy']:.4f} (steps "
        f"{hist[0]['step']} / {hist[-1]['step']}); create_vector_dbs {t_dbs:.2f} s in all")

    # the saved npz: the card's encoder and the CPU's, loaded from it
    model = load_params(EmbeddingModel(EncoderConfig(), device=dev), params)
    cpu_model = load_params(EmbeddingModel(EncoderConfig(), device="cpu"), params)
    sample = texts[:: max(1, len(texts) // 12)][:12]
    a, b, t = model.embed(sample), cpu_model.embed(sample), trained.embed(sample)
    cos = float(((a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                   * np.linalg.norm(b, axis=1))).min())
    check(cos >= 0.99999 and float(np.abs(a - t).max()) <= 1e-6,
          f"the saved params through the CPU encoder: cos {cos}")

    # 9b's questions over the trained index, card against CPU
    embed = EmbedOnce(model, dev)
    gp = Pipeline(root, rc, embedder=embed, provider=ExtractiveStubProvider(), device=dev)
    proc = gp.build_processor()
    zero_counts()
    with FirstCalls() as first:
        payloads, t_q = wall(lambda: [proc.process_question(q["question"], q["schema"])
                                      for q in ctx9["questions"]], dev)
    counts = read_counts()
    errs = check_first_calls("10b (pipeline, trained encoder)", first.calls)
    cproc = Pipeline(root, rc, embedder=embed.cached, provider=ExtractiveStubProvider(),
                     device="cpu").build_processor()
    tied = sum(same_ask(f"10b: {q['question']}",
                        json.loads(json.dumps(g, ensure_ascii=False)),
                        json.loads(json.dumps(cproc.process_question(
                            q["question"], q["schema"]), ensure_ascii=False)), K1_TOL)
               for q, g in zip(ctx9["questions"], payloads))
    n_q = len(ctx9["questions"])
    per_q = {k: v / n_q for k, v in counts.items()}
    check(tied <= 1 and per_q["dense_topk"] > 0 and per_q["span_gather"] > 0,
          f"10b questions: {tied} reordered ties, launches {per_q}")
    log(f"{n_q} questions over the trained index: {t_q / n_q * 1e3:.1f} ms each, launches "
        f"a question {per_q}, == the CPU pipeline's (reordered ties: {tied}); the saved "
        f"params through the CPU encoder: cos >= {cos:.7f} on {len(sample)} chunks")

    # eval_hybrid_e2e with the trained encoder: the routed engine (K1 + K2)
    e2e_embed = EmbedOnce(model, dev)
    zero_counts()
    e2e, t_e2e = wall(lambda: eval_hybrid_e2e(e2e_embed, device=dev), dev)
    e2e_counts = read_counts()
    e2e_cpu = eval_hybrid_e2e(e2e_embed.cached, device="cpu")
    check(abs(e2e["hit@10"] - e2e_cpu["hit@10"]) <= 1 / 17 + 1e-9
          and e2e_counts["dense_topk"] > 0,
          f"eval_hybrid_e2e: card {e2e} vs CPU {e2e_cpu}, launches {e2e_counts}")
    log(f"eval_hybrid_e2e (trained encoder): card {e2e} in {t_e2e:.2f} s, CPU {e2e_cpu}; "
        f"launches over its 17 questions {e2e_counts}")

    split = loop_split(dev, texts, PretrainConfig())
    log(f"the loop over 20 steps: sampler + tokenizer {split['sampler_ms']:.2f} ms a step "
        f"(host), train step {split['step_ms']:.2f} ms (CUDA events), the loop "
        f"{split['loop_ms']:.2f} ms a step with the card "
        + (f"{100 * split['busy']:.1f}% busy" if split["busy"] else "busy: not measured"))
    return dict(steps=steps, chunks=len(texts), pretrain_s=t_pre, steps_s=steps / t_pre,
                create_vector_dbs_s=t_dbs, loss_first=hist[0]["loss"],
                loss_last=hist[-1]["loss"], accuracy_first=hist[0]["accuracy"],
                accuracy_last=hist[-1]["accuracy"], cpu_cos=cos,
                ms_per_question=t_q / n_q * 1e3, launches_per_question=per_q, tied=tied,
                kernel_errs=errs, e2e=e2e, e2e_cpu=e2e_cpu,
                e2e_launches_per_question={k: v / 17 for k, v in e2e_counts.items()},
                split=split, seconds=time.perf_counter() - t_phase)


def phase10c_device_teacher(dev, texts, steps=20):
    """20 pretraining steps with ``host_teacher=False``: the mining teacher
    is ``bm25_scores`` on the card (K2); its launches per step, and its
    scores against ``HostBM25Scorer`` on the same queries."""
    import numpy as np

    from rag_challenge_2_tpu_torch.models.pretrain import (
        PairSampler, PretrainConfig, pretrain_encoder)

    log("== phase 10c: the device teacher (host_teacher=False)")
    t0 = time.perf_counter()
    pre = PretrainConfig(steps=steps, host_teacher=False)
    zero_counts()
    with FirstCalls() as first:
        (_, info), t = wall(lambda: pretrain_encoder(texts, pre_cfg=pre, device=dev,
                                                     log_every=1), dev)
    k2 = read_counts()["span_gather"]
    errs = check_first_calls("10c (device teacher)", first.calls)
    check(k2 > 0 and all(np.isfinite(h["loss"]) for h in info["history"]),
          f"the device teacher: {k2} K2 launches, history {info['history'][-1]}")
    host = PairSampler(texts, PretrainConfig(), device=dev)
    card = PairSampler(texts, pre, device=dev)
    check(card._sparse.indptr.device.type == "cuda", "the device teacher's CSR is not on the card")
    rng = np.random.default_rng(10)
    queries = [card._crop(texts[int(i)], rng) for i in rng.integers(0, len(texts), 64)]
    a, b = card._teacher_scores(queries), host._teacher_scores(queries)
    err = float(np.abs(a - b).max())
    check(np.allclose(a, b, rtol=2e-5, atol=2e-5), f"device teacher vs host: {err}")
    log(f"{steps} steps in {t:.2f} s ({steps / t:.1f} steps/s), {k2} K2 launches = "
        f"{k2 / steps:.2f} a step; teacher scores of 64 crops x {len(texts)} chunks on the "
        f"card == HostBM25Scorer within 2e-5 (max |diff| {err:.2e})")
    return dict(steps=steps, steps_s=steps / t, k2_launches=k2,
                k2_per_step=k2 / steps, teacher_err=err, kernel_errs=errs,
                seconds=time.perf_counter() - t0)


def phase10d_quality(dev, seed, ict_steps=5000, supervised_steps=2000, ablation_steps=200):
    """``run_quality_eval`` on the card: the default recipe at its recorded
    5,000 steps, the four ablation arms at 200 (the smoke's time limit),
    the supervised stage at 2,000; every arm beside docs/ENCODER_QUALITY.json; gates: BM25 equals
    the CPU's, the default recipe >= 0.55 hit@10 and >= 0.2 above the
    random encoder; the K3 / K2 launches of ``eval_hybrid``."""
    import rag_challenge_2_tpu_torch.eval.encoder_quality as eq

    log(f"== phase 10d: the encoder quality eval on the card ({ict_steps} steps, "
        f"ablations {ablation_steps}, supervised {supervised_steps})")
    t0 = time.perf_counter()
    lines = []
    zero_counts()
    with Timed(eq, "eval_hybrid") as hy, FirstCalls() as first:
        res = eq.run_quality_eval(ict_steps=ict_steps, supervised_steps=supervised_steps,
                                  batch_size=64, seed=seed, log=lines.append, device=dev,
                                  ablation_steps=ablation_steps)
    counts = read_counts()
    errs = check_first_calls("10d (quality eval)", first.calls)
    for ln in lines:
        log("  " + ln)
    bm25_cpu = eq.eval_bm25(eq.build_dataset(seed=seed), device="cpu")
    alias, rand = res["encoder_alias_distill"]["hit@10"], res["encoder_random_init"]["hit@10"]
    for arm, m in res.items():
        rec = QUALITY_RECORD.get(arm)
        log(f"{arm}: hit@10 {m['hit@10']} mrr {m['mrr']}"
            + (f" (recorded {rec[0]} / {rec[1]})" if rec else ""))
    check(res["bm25"] == bm25_cpu, f"bm25 on the card {res['bm25']} vs the CPU {bm25_cpu}")
    check(len(hy.calls) == 2 and counts["stream_topk"] > 0 and counts["span_gather"] > 0,
          f"the quality eval's launches {counts}")
    check(alias >= 0.55 and alias >= rand + 0.2,
          f"encoder_alias_distill hit@10 {alias} (random init {rand})")
    out = dict(results=res, bm25_cpu=bm25_cpu, launches=counts, kernel_errs=errs,
               hybrid_s=[c[0] for c in hy.calls], ict_steps=ict_steps,
               ablation_steps=ablation_steps, supervised_steps=supervised_steps,
               seconds=time.perf_counter() - t0)
    log(f"the quality eval's launches {counts} (two eval_hybrid calls of 200 stacked "
        f"queries, one eval_bm25); phase 10d took {out['seconds']:.1f} s")
    return out


def cli_train_chain(root, env, device, auto_steps, train_steps):
    """``parse-pdfs`` → ``process-reports`` (the auto-pretrain) →
    ``train-encoder --steps 40`` → ``process-reports`` (the saved params
    loaded) → ``query``, each in a subprocess on the card."""
    def run(*args):
        out = subprocess.run(
            [sys.executable, "-m", "rag_challenge_2_tpu_torch", *args, "--root", str(root),
             "--device", device], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        check(out.returncode == 0, f"CLI {args[0]}: {out.stderr[-2000:]}")
        return out.stdout

    run("parse-pdfs")
    first = run("process-reports")
    check(f"ICT-pretraining {auto_steps} steps" in first,
          f"process-reports did not pretrain: {first}")
    trained = json.loads(run("train-encoder", "--steps", str(train_steps))
                         .strip().splitlines()[-1])
    check(trained["step"] == train_steps - 1 and Path(trained["params"]).exists(),
          f"train-encoder: {trained}")
    second = run("process-reports")
    check("loaded corpus-pretrained params" in second and "ICT-pretraining" not in second,
          f"process-reports did not load the saved params: {second}")
    hits = [ln for ln in run("query", "--company", COMPANY, "--question",
                             f"{COMPANY}2024年营业收入是多少？", "--use-bm25").splitlines()
            if QUERY_LINE.match(ln)]
    check(3 <= len(hits) <= 5, f"query: {hits}")
    return dict(train=trained, hits=len(hits))


def cli_eval(path, env, device, ict_steps, supervised_steps):
    out = subprocess.run(
        [sys.executable, "-m", "rag_challenge_2_tpu_torch", "eval-encoder", "--ict-steps",
         str(ict_steps), "--supervised-steps", str(supervised_steps), "--out", str(path),
         "--device", device],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"eval-encoder: {out.stderr[-2000:]}")
    res = json.loads(path.read_text("utf-8"))
    check(json.loads(out.stdout.strip().splitlines()[-1]) == res
          and set(QUALITY_RECORD) | {"hybrid_random_init"} == set(res),
          f"eval-encoder's JSON: {sorted(res)}")
    return res


def phase10e_cli(work, device="cuda", auto_steps=300, train_steps=40, ict_steps=50,
                 supervised_steps=20):
    """The training commands in subprocesses on the card, in parallel: the
    train chain on a copy of ``data/test_set`` and ``eval-encoder`` at 50 /
    20 steps."""
    import os
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    log("== phase 10e: train-encoder and eval-encoder through the CLI")
    t0 = time.perf_counter()
    root = work / "cli_train"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "data" / "test_set", root)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RAGTPU_AUTO_PRETRAIN", "RAGTPU_AUTO_PRETRAIN_STEPS")}
    env.update(PYTHONPATH=str(ROOT), RAGTPU_AUTO_PRETRAIN_STEPS=str(auto_steps))
    with ThreadPoolExecutor(2) as ex:
        chain = ex.submit(cli_train_chain, root, env, device, auto_steps, train_steps)
        ev = ex.submit(cli_eval, work / "eval_encoder.json", env, device, ict_steps,
                       supervised_steps)
        chain, ev = chain.result(), ev.result()
    out = dict(train=chain["train"], query_hits=chain["hits"], eval_arms=sorted(ev),
               eval=ev, seconds=time.perf_counter() - t0)
    log(f"CLI: parse-pdfs, process-reports (auto-pretrain {auto_steps} steps), "
        f"train-encoder --steps {train_steps} ({chain['train']}), process-reports (saved "
        f"params loaded), query ({chain['hits']} hits); eval-encoder --ict-steps "
        f"{ict_steps} --supervised-steps {supervised_steps}: every arm's key; phase 10e "
        f"took {out['seconds']:.1f} s")
    return out


def phase10_training(dev, seed, work, ctx9):
    """Phase 10: encoder training on the card (10a-10e; 10e beside 10d)."""
    from concurrent.futures import ThreadPoolExecutor

    from rag_challenge_2_tpu_torch.index.build import load_chunked_reports
    from rag_challenge_2_tpu_torch.pipeline import PipelineConfig

    t0 = time.perf_counter()
    texts = [c["text"] for r in load_chunked_reports(PipelineConfig(ctx9["root"]).documents_dir)
             for c in r["content"]["chunks"]]
    out = {"step": phase10a_step(dev, seed, texts)}
    out["auto_pretrain"] = phase10b_auto_pretrain(dev, ctx9)
    out["device_teacher"] = phase10c_device_teacher(dev, texts)
    # 10e's subprocesses run beside 10d: other host cores, the same card
    with ThreadPoolExecutor(1) as ex:
        cli = ex.submit(phase10e_cli, work)
        out["quality"] = phase10d_quality(dev, seed)
        out["cli"] = cli.result()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 10 took {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------- main

# --------------------------------------------------------------- phase 11

P11_GRID = ("slice", "device")
P11_IVF_LISTS = 1024        # 11c's lists a shard
P11_ONE_CARD = ("four ranks share one card: these times show that the merge is "
                "right, not that it scales")


def _every(x):
    """Every rank's ``x``, in rank order (a gloo all-gather of objects)."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_ms(dev, fn, reps):
    """``(fn(), ms a call)`` on a rank: one warm-up call, then ``reps``
    calls between two barriers, the card synchronised (every rank's
    time is the world's)."""
    import torch.distributed as dist

    fn()
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(dev)
    dist.barrier()
    return out, (time.perf_counter() - t0) / reps * 1e3


def rank11a_nccl(dev, q, emb):
    """11a in the one rank of an NCCL world: the flat and the 1 x 1
    two-level merge against ``dense_topk`` on the deployment store."""
    import torch
    import torch.distributed as dist

    from rag_challenge_2_tpu_torch.ops.topk import dense_topk
    from rag_challenge_2_tpu_torch.parallel import (
        hierarchical_dense_topk, make_mesh, sharded_dense_topk)

    flat = make_mesh({"data": 1}, "nccl", "cuda")
    hier = make_mesh({"slice": 1, "device": 1}, "nccl", "cuda")
    zero_counts()
    sv, si = sharded_dense_topk(q, emb, 30, flat)
    hv, hi = hierarchical_dense_topk(q, emb, 30, hier)
    launches = read_counts()
    xv, xi = dense_topk(q, emb, 30)
    return dict(dev=str(dev), backend=dist.get_backend(), launches=launches,
                same=bool(torch.equal(si, xi) and torch.equal(hi, xi)
                          and torch.equal(sv, xv) and torch.equal(hv, xv)))


def nccl_two_ranks_one_card(rank, init, out):
    """Two NCCL ranks on cuda:0: what NCCL says (a check, recorded)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=init, world_size=2, rank=rank,
                                timeout=timedelta(seconds=60))
        x = torch.ones(4, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out.put((rank, "all_reduce ran"))
    except Exception as e:                  # recorded, the check's answer
        out.put((rank, f"{type(e).__name__}: {str(e).splitlines()[-1][:200]}"))


def phase11a_nccl(dev, ctx3):
    import os
    import tempfile

    import torch

    from rag_challenge_2_tpu_torch.parallel import run_ranks

    emb = ctx3["eng"].index.emb
    q = ctx3["requests"][0][3]
    r, t = wall(lambda: run_ranks(rank11a_nccl, 1, "nccl", "cuda", (q, emb),
                                  timeout=300), dev)
    log(f"11a backend nccl, world 1, rank devices [{r['dev']}]")
    check(r["same"], "11a: the NCCL sharded / two-level top-k differs from dense_topk")
    check(r["launches"]["dense_topk"] == 2, f"11a: K1 launches {r['launches']}")
    log(f"11a: sharded_dense_topk and hierarchical_dense_topk (1 x 1) over NCCL on the "
        f"deployment store ({emb.shape[0]} x {emb.shape[1]}, B = {q.shape[0]}, k = 30) "
        f"== dense_topk bitwise; K1 launches {r['launches']['dense_topk']}; world "
        f"started, ran and ended in {t:.1f} s")
    # NCCL with two ranks on the one card (run_ranks refuses it before it starts)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rc2_nccl2_")
    out = ctx.Queue()
    procs = [ctx.Process(target=nccl_two_ranks_one_card, daemon=True,
                         args=(i, "file://" + os.path.join(tmp, "s"), out))
             for i in range(2)]
    for p in procs:
        p.start()
    said, t0 = {}, time.monotonic()
    while len(said) < 2 and time.monotonic() - t0 < 60:
        try:
            rank, msg = out.get(timeout=1.0)
            said[rank] = msg
        except Exception:                   # queue.Empty: keep waiting
            pass
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(5)
    log(f"11a: nccl with 2 ranks on one card: {said or 'no answer in 60 s'}")
    return dict(nccl_world1_s=t, nccl_two_ranks_one_card=said)


def rank11b_scan(dev, d):
    """11b on a rank: config 5's 10M int8 scan, flat over 4 ranks and
    two-level over 2 x 2; each rank's merged result against the
    single-device K3's."""
    import torch

    from rag_challenge_2_tpu_torch.parallel import (
        make_hierarchical_topk, make_mesh, make_sharded_topk)
    from rag_challenge_2_tpu_torch.parallel.sharded_search import shard_rows, shard_vec

    flat = make_mesh({"data": 4}, "gloo")
    el, sl = shard_rows(d["buf"], flat), shard_vec(d["scales"], flat)
    out = {}
    for name, fn in (("flat", make_sharded_topk(flat, 30, "data", int8=True)),
                     ("hier", make_hierarchical_topk(make_mesh({"slice": 2, "device": 2}),
                                                     30, int8=True))):
        zero_counts()
        (v, i), ms = _rank_ms(dev, lambda: fn(d["q"], el, None, sl), 3)
        same = torch.equal(v, d["ref_v"]) and torch.equal(i.long(), d["ref_i"].long())
        out[name] = dict(ms=ms, rows=i.cpu().numpy(), every=_every(dict(
            dev=str(dev), rows=el.shape[0], same=bool(same),
            k3=read_counts()["stream_topk"])))
    return out


def rank11c_ivf(dev, d):
    """11c on a rank: its IVF over its 250,000 rows of the 1M store (1,024
    lists), then the sharded probe search at each nprobe."""
    import torch

    from rag_challenge_2_tpu_torch.parallel import make_mesh
    from rag_challenge_2_tpu_torch.parallel.sharded_ivf import (
        build_sharded_ivf, sharded_ivf_search)

    flat = make_mesh({"data": 4}, "gloo")
    _sync(dev)
    t0 = time.perf_counter()
    sivf = build_sharded_ivf(d["emb"], flat, n_clusters=d["K"], iters=10, seed=0)
    _sync(dev)
    build_s = time.perf_counter() - t0
    zero_counts()
    found = {}
    for nprobe in d["nprobes"]:
        # every list probed holds [G, max_list] spans of 32 queries at a time
        step = 32 if nprobe == sivf.k_clusters else d["q"].shape[0]

        def search(nprobe=nprobe, step=step):
            parts = [sharded_ivf_search(sivf, d["q"][s:s + step], 10, nprobe=nprobe)
                     for s in range(0, d["q"].shape[0], step)]
            return torch.cat([v for v, _ in parts]), torch.cat([r for _, r in parts])

        (v, r), ms = _rank_ms(dev, search, 1)
        found[nprobe] = (v.cpu().numpy(), r.cpu().numpy(), ms)
    return dict(found=found, k_clusters=sivf.k_clusters, max_list=sivf.max_list,
                every=_every(dict(dev=str(dev), build_s=build_s,
                                  n_pad=sivf.local.emb_perm.shape[0],
                                  launches=read_counts())))


def rank11d_engine(dev, d):
    """11d on a rank: QueryEngine(hier=...) on the deployment, its rows,
    its BM25 shard and its IVF shard; 16 requests a configuration."""
    import dataclasses

    from rag_challenge_2_tpu_torch.parallel import make_mesh
    from rag_challenge_2_tpu_torch.parallel.sharded_ivf import build_sharded_ivf
    from rag_challenge_2_tpu_torch.parallel.sharded_search import shard_rows
    from rag_challenge_2_tpu_torch.parallel.sharded_sparse import shard_sparse_index
    from rag_challenge_2_tpu_torch.retrieval import QueryEngine

    mesh = make_mesh(dict(zip(P11_GRID, (2, 2))), "gloo")
    idx = d["idx"]
    mine = dataclasses.replace(idx, emb=shard_rows(idx.emb, mesh, P11_GRID),
                               sparse=shard_sparse_index(idx.sparse, 4, mesh, P11_GRID))
    _sync(dev)
    t0 = time.perf_counter()
    sivf = build_sharded_ivf(idx.emb, mesh, n_clusters=d["K"], valid=idx.valid,
                             axis=P11_GRID)
    _sync(dev)
    build_s = time.perf_counter() - t0
    eng = QueryEngine(mine, d["meta"], ivf=sivf, hier=(mesh, *P11_GRID))
    out = dict(build_s=build_s, window=eng.window)
    for name, cfg in d["cfgs"].items():
        def run(cfg=cfg):
            return [eng.search(qe, COMPANY, question, years, cfg, query_texts=qtexts)
                    for question, qtexts, years, qe in d["requests"]]

        zero_counts()
        cands, ms = _rank_ms(dev, run, 1)
        n = 2 * len(d["requests"])                      # warm-up + timed
        out[name] = dict(
            cands=[c.to("cpu") for c in cands], ms=ms / len(d["requests"]),
            materialized=eng.materialize(cands[0], cfg),
            every=_every(dict(dev=str(dev), rows=mine.emb.shape[0], launches={
                k: v / n for k, v in read_counts().items()})))
    return out


def rank11e_hybrid(dev, d):
    """11e on a rank: phase 6c's 10M int8 hybrid through search_device with
    the dense arm via hier and BM25 via this rank's CSR shard."""
    import dataclasses

    from rag_challenge_2_tpu_torch.parallel import make_mesh
    from rag_challenge_2_tpu_torch.parallel.sharded_search import shard_rows, shard_vec
    from rag_challenge_2_tpu_torch.parallel.sharded_sparse import take_shard
    from rag_challenge_2_tpu_torch.retrieval import search_device

    mesh = make_mesh(dict(zip(P11_GRID, (2, 2))), "gloo")
    idx = d["idx"]
    mine = dataclasses.replace(
        idx, emb=shard_rows(idx.emb, mesh, P11_GRID),
        emb_scale=shard_vec(idx.emb_scale, mesh, P11_GRID),
        sparse=take_shard(d["sparse"], mesh, P11_GRID))
    hier = (mesh, *P11_GRID)

    def run():
        return [search_device(mine, rq, d["cfg"], window=d["window"], hier=hier)[0]
                for rq in d["hreqs"]]

    zero_counts()
    fused, ms = _rank_ms(dev, run, 1)
    n = 2 * len(d["hreqs"])
    return dict(fused=[f.to("cpu") for f in fused], ms=ms / len(d["hreqs"]),
                every=_every(dict(dev=str(dev), rows=mine.emb.shape[0], launches={
                    k: v / n for k, v in read_counts().items()})))


def rank11_world(dev, b):
    """The rank program of phase 11b-e: one gloo world of 4 ranks on the
    card runs the four sub-phases in turn."""
    return dict(scan=rank11b_scan(dev, b["scan"]), ivf=rank11c_ivf(dev, b["ivf"]),
                engine=rank11d_engine(dev, b["engine"]),
                hybrid=rank11e_hybrid(dev, b["hybrid"]))


def _devices(every):
    return "[" + ", ".join(e["dev"] for e in every) + "]"


def phase11_sharded(dev, seed, ctx3, ctx6, p6):
    """Phase 11: the sharded serving path (the JAX package's config-5 form)
    on the card.  11a: an NCCL world of one rank.  11b-e: one gloo world of
    4 ranks, all on cuda:0, handed the stores through CUDA IPC: config 5's
    10M int8 scan flat and two-level, the sharded IVF at 1M, the engine's
    hier / ShardedSparseIndex / ShardedIVF branches on the deployment, and
    the 10M hybrid end to end, each held against the single-device path."""
    import numpy as np
    import torch

    from rag_challenge_2_tpu_torch.ops.dense_topk import dense_topk_fused
    from rag_challenge_2_tpu_torch.ops.topk import dense_topk
    from rag_challenge_2_tpu_torch.parallel import run_ranks
    from rag_challenge_2_tpu_torch.parallel.sharded_sparse import shard_sparse_index
    from rag_challenge_2_tpu_torch.retrieval import SearchConfig

    log("== phase 11: the sharded serving path (BASELINE config 5's multi-shard form)")
    t_phase = time.perf_counter()
    out = phase11a_nccl(dev, ctx3)

    # 11b: the single-device K3 on the 10M int8 store, the reference
    data = ctx6
    q10 = data["q"]
    ref_v, ref_i = dense_topk(q10, data["buf"], 30, row_scale=data["scales"])
    ref_ms = statistics.median(
        wall(lambda: dense_topk(q10, data["buf"], 30, row_scale=data["scales"]), dev)[1]
        for _ in range(3)) * 1e3
    # 11c: phase 5's 1M f32 store rebuilt from its seed, the exact oracle
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb1m, q1m = ivf_data(dev, gen, 1_000_000, 1024)
    blocks = [dense_topk_fused(q1m[s:s + 64].contiguous(), emb1m, 10)
              for s in range(0, q1m.shape[0], 64)]
    oracle1m_v = torch.cat([v for v, _ in blocks])
    oracle1m = torch.cat([i for _, i in blocks]).cpu().numpy()
    K_SHARD = P11_IVF_LISTS
    # 11d: the single-device card engine over phase 3's requests
    eng = ctx3["eng"]
    reqs = ctx3["requests"]
    cfgs = {
        "dense": SearchConfig(method="basic", top_k=30, top_n=30),
        "bm25": SearchConfig(method="basic", top_k=30, top_n=30, use_bm25=True,
                             bm25_top_k=30),
        "bm25_ivf": SearchConfig(method="basic", top_k=30, top_n=30, use_bm25=True,
                                 bm25_top_k=30, use_ivf=True, ivf_nprobe=32),
    }
    single = {name: [eng.search(qe, COMPANY, question, years, c, query_texts=qtexts)
                     for question, qtexts, years, qe in reqs]
              for name, c in cfgs.items() if not c.use_ivf}
    single_mat = eng.materialize(single["bm25"][0], cfgs["bm25"])
    # 11e: 6c's hybrid and its CSR partitioned on the host, stacked on the card
    hyb = data["hybrid"]
    stacked, t_part = wall(lambda: shard_sparse_index(hyb["idx"].sparse, 4), dev)
    log(f"11e: the 10M CSR ({int(hyb['idx'].sparse.indptr[-1])} postings) partitioned "
        f"into 4 row-range shards on the host in {t_part:.1f} s "
        f"(L {stacked.chunk_ids.shape[1]}, max_postings {stacked.max_postings})")
    bundle = dict(
        scan=dict(buf=data["buf"], scales=data["scales"], q=q10, ref_v=ref_v, ref_i=ref_i),
        ivf=dict(emb=emb1m, q=q1m, K=K_SHARD, nprobes=(2, 4, 8, K_SHARD)),
        engine=dict(idx=eng.index, meta=eng.meta, requests=reqs, cfgs=cfgs, K=32),
        hybrid=dict(idx=hyb["idx"], sparse=stacked, hreqs=hyb["hreqs"], cfg=hyb["cfg"],
                    window=hyb["window"]))
    r, t_world = wall(lambda: run_ranks(rank11_world, 4, "gloo", dev.type, (bundle,),
                                        timeout=900), dev)
    del bundle, stacked
    torch.cuda.empty_cache()
    log(f"11b-e: one gloo world of 4 ranks on the card started, ran and ended in "
        f"{t_world:.1f} s")

    # 11b
    sc = r["scan"]
    res = {}
    for name in ("flat", "hier"):
        every = sc[name]["every"]
        log(f"11b {name}: backend gloo, world 4 ({'data 4' if name == 'flat' else 'slice 2 x device 2'}), "
            f"rank devices {_devices(every)}")
        check(all(e["same"] for e in every),
              f"11b {name}: a rank's merged result differs from the single-device K3")
        check(all(e["k3"] == 4 for e in every), f"11b {name}: K3 launches {every}")
        rec = recall_at(sc[name]["rows"], data["oracle"], 10)
        res[name] = dict(ms=sc[name]["ms"], recall10=rec)
        log(f"11b {name}: 10M x 1024 int8, 127 queries, k = 30, {every[0]['rows']} rows a "
            f"rank: rows and values bitwise equal to the single-device K3 on every rank; "
            f"recall@10 {rec:.4f} against phase 6's oracle (single device reads the same "
            f"rows); {sc[name]['ms']:.2f} ms a call against the single-device "
            f"{ref_ms:.2f} ms (phase 6's K3 kernel {p6['k3_10m']['int8']['ms']:.3f} ms); "
            f"{P11_ONE_CARD}")
    out["scan"] = dict(res, single_ms=ref_ms)

    # 11c
    iv = r["ivf"]
    every = iv["every"]
    log(f"11c: backend gloo, world 4 (data 4), rank devices {_devices(every)}")
    log(f"11c: IVF per shard over {emb1m.shape[0] // 4} rows of the "
        f"{emb1m.shape[0]} x {emb1m.shape[1]} f32 store: K "
        f"{iv['k_clusters']}, common max_list {iv['max_list']}, n_pad "
        f"{every[0]['n_pad']}; build s by rank "
        + ", ".join("%.2f" % e["build_s"] for e in every))
    check(all(e["launches"]["probe_scores"] > 0 and e["launches"]["span_gather"] > 0
              for e in every), f"11c: K4 / K2 did not launch on every rank: {every}")
    sweep = {}
    for nprobe, (v, rows, ms) in iv["found"].items():
        rec = recall_at(rows, oracle1m, 10)
        sweep[nprobe] = dict(recall10=rec, ms=ms)
        log(f"11c: nprobe {nprobe} a shard ({4 * nprobe} lists probed): recall@10 "
            f"{rec:.4f}, {ms:.2f} ms a call of 127 queries")
    v, rows, _ = iv["found"][K_SHARD]
    sure = untied(oracle1m_v, 1e-5).cpu().numpy()
    check((rows[sure] == oracle1m[sure]).all(),
          "11c: at nprobe = K the rows differ from the exact oracle where untied")
    check(np.abs(v - oracle1m_v.cpu().numpy()).max() <= 1e-4,
          "11c: at nprobe = K the values differ from the oracle")
    log(f"11c: at nprobe = K = {K_SHARD} the rows equal the exact oracle "
        f"({int(sure.sum())} of {sure.size} untied positions), values within 1e-4")
    out["ivf"] = dict(sweep=sweep, build_s=[e["build_s"] for e in every],
                      max_list=iv["max_list"])
    del emb1m, q1m
    torch.cuda.empty_cache()

    # 11d
    en = r["engine"]
    log(f"11d: the deployment's IVF per shard (K 32, nprobe 32 = every list) built in "
        f"{en['build_s']:.2f} s; window {en['window']}")
    res = {}
    for name, c in cfgs.items():
        every = en[name]["every"]
        log(f"11d {name}: backend gloo, world 4 (slice 2 x device 2), rank devices "
            f"{_devices(every)}, {every[0]['rows']} rows a rank")
        ref = single["bm25" if c.use_ivf else name]
        reordered = sum(same_candidates(a, b, 1e-4) for a, b in zip(en[name]["cands"], ref))
        if name == "bm25":
            got = en[name]["materialized"]
            check(len(got) == len(single_mat) and all(
                abs(a["distance"] - b["distance"]) <= 1e-4 for a, b in zip(got, single_mat)),
                "11d: materialized results differ from the single-device engine's")
        per_rank = [e["launches"] for e in every]
        sums = {k: sum(p[k] for p in per_rank) for k in per_rank[0]}
        want = ("probe_scores", "span_gather") if c.use_ivf else (
            ("dense_topk", "span_gather") if c.use_bm25 else ("dense_topk",))
        check(all(sums[k] > 0 for k in want), f"11d {name}: launches {per_rank}")
        check(all(sum(p.values()) > 0 for p in per_rank),
              f"11d {name}: a rank launched no kernel: {per_rank}")
        res[name] = dict(ms_per_request=en[name]["ms"], launches_per_request=sums,
                         launches_per_rank=per_rank, reordered_ties=reordered)
        log(f"11d {name}: 16 requests == the single-device card engine"
            f"{' (exact path: nprobe = K)' if c.use_ivf else ''} (tie groups reordered: "
            f"{reordered}); {en[name]['ms']:.2f} ms a request; launches a request by rank "
            + "; ".join(", ".join(f"{k} {v:g}" for k, v in p.items() if v) for p in per_rank)
            + f"; {P11_ONE_CARD}")
    out["engine"] = res

    # 11e
    hy = r["hybrid"]
    every = hy["every"]
    log(f"11e: backend gloo, world 4 (slice 2 x device 2), rank devices "
        f"{_devices(every)}, {every[0]['rows']} rows a rank")
    reordered = sum(same_candidates(a, b, 1e-4) for a, b in zip(hy["fused"], hyb["fused"]))
    per_rank = [e["launches"] for e in every]
    sums = {k: sum(p[k] for p in per_rank) for k in per_rank[0]}
    check(sums["stream_topk"] > 0 and all(p["span_gather"] > 0 for p in per_rank),
          f"11e: K3 / K2 launches {per_rank}")
    nq = hyb["hreqs"][0].q.shape[0]
    one = p6["engine"]["hybrid_10m_rtNone"]
    log(f"11e: the 10M int8 hybrid through the sharded engine (dense via hier, BM25 via "
        f"ShardedSparseIndex): 16 requests == phase 6c's single-device candidates (tie "
        f"groups reordered: {reordered}); {hy['ms']:.2f} ms a request = "
        f"{nq / hy['ms'] * 1e3:.1f} queries/s against 6c's {one['qps']:.1f} queries/s; "
        f"launches a request by rank "
        + "; ".join(", ".join(f"{k} {v:g}" for k, v in p.items() if v) for p in per_rank)
        + f"; {P11_ONE_CARD}")
    out["hybrid"] = dict(ms_per_request=hy["ms"], qps=nq / hy["ms"] * 1e3,
                         single_qps=one["qps"], launches_per_request=sums,
                         launches_per_rank=per_rank, reordered_ties=reordered)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 11 took {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- phase 12

P12_EXPERTS = 4             # __graft_entry__.py's and tests/test_models.py's MoE
P12_CHUNKS = 256            # 12a's chunks, card against CPU


def router_choices(module):
    """Forward hooks on every MoE router of ``module``: each forward appends
    ``(routing, gap)`` per token of each MoE block: ``routing`` the block's
    own ``MoEFFN.routing`` of these logits (``[T, 4]``: e1, e2, kept1,
    kept2), ``gap`` the router's margin (the smaller of the first-second
    and second-third probability gaps).  Returns ``(records, remove)``."""
    import torch

    records, hooks = [], []

    def hook_of(moe):
        def hook(_mod, _inp, logits):
            logits = logits.detach().float()
            top = torch.sort(torch.softmax(logits, -1), -1, descending=True)[0]
            gap = torch.minimum(top[:, 0] - top[:, 1], top[:, 1] - top[:, 2])
            records.append((moe.routing(logits).cpu(), gap.cpu()))
        return hook

    for blk in module.blocks:
        if hasattr(blk, "moe"):
            hooks.append(blk.moe.router.register_forward_hook(hook_of(blk.moe)))
    return records, lambda: [h.remove() for h in hooks]


def moe_step_ops(q, p, cfg, module):
    """:func:`train_step_ops` with the MoE blocks' FFN counted at capacity:
    a MoE block runs its E experts on C = ``MoEFFN.capacity(T)`` slots
    each (every slot, filled or not; 4 d d_ff a slot forward) and its
    router (2 d E a token) in place of the dense MLP's 4 d d_ff a valid
    token; each of the step's two forwards (q, d) routes its own T = B L
    tokens."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    moes = [blk.moe for blk in module.blocks if hasattr(blk, "moe")]
    fwd = train_step_ops(q, p, cfg) / 3
    for tokens in (q, p):
        valid = float((tokens >= 0).sum())
        T = tokens.numel()
        for moe in moes:
            C = moe.capacity(T)
            fwd += E * C * 4 * d * ff + T * 2 * d * E - valid * 4 * d * ff
    return 3 * fwd


def phase12a_embed(dev, texts, cfg, weights):
    """12a: the MoE encoder ``cfg`` with ``weights`` on 256 chunks through
    ``EmbeddingModel.embed`` on the card.  Returns ``(model, cpu_job,
    finish)``: ``cpu_job()`` runs the same on the CPU (the caller runs it
    beside 12d), ``finish(cpu_job())`` holds the two (routing flips, row
    cosines) and returns 12a's results."""
    import torch

    from rag_challenge_2_tpu_torch.models.encoder import EmbeddingModel

    model = EmbeddingModel(cfg, params=weights, device=dev)
    n_params = sum(t.numel() for t in model.module.parameters())
    cpu = EmbeddingModel(cfg, params=weights, device="cpu")
    sample = texts[:P12_CHUNKS]

    def run(m):
        rec, remove = router_choices(m.module)
        out, t = wall(lambda: m.embed(sample), torch.device("cpu"))
        remove()
        return out, rec, t

    card = run(model)
    return model, lambda: run(cpu), lambda cpu_run: phase12a_check(
        cfg, sample, n_params, card, cpu_run)


def phase12a_check(cfg, sample, n_params, card, cpu_run):
    import numpy as np
    import torch

    (a, rg, t_card), (b, rc, t_cpu) = card, cpu_run
    check(len(rg) == len(rc) == 2, f"12a: {len(rg)} / {len(rc)} MoE block calls")
    check(np.isfinite(a).all() and a.shape == (len(sample), cfg.out_dim),
          "12a: MoE embeddings must be finite [n, out_dim]")
    L = rg[0][0].shape[0] // len(sample)
    touched = torch.zeros(len(sample), dtype=torch.bool)
    pair_flips = kept_changes = 0
    flip_gap = 0.0
    for (g, gap), (c, _) in zip(rg, rc):
        pair = (g[:, :2] != c[:, :2]).any(1)
        kept = (g[:, 2:] != c[:, 2:]).any(1) & ~pair
        pair_flips += int(pair.sum())
        kept_changes += int(kept.sum())
        if pair.any():
            flip_gap = max(flip_gap, float(gap[pair].max()))
        touched |= (pair | kept).view(len(sample), L).any(1)
    tokens = sum(r.shape[0] for r, _ in rg)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    clear = ~touched.numpy()
    cos_min = float(cos[clear].min()) if clear.any() else float("nan")
    log(f"12a: MoE encoder (default EncoderConfig, moe_experts {P12_EXPERTS}): {n_params} "
        f"parameters; {len(sample)} chunks of 9b through EmbeddingModel.embed (L {L}, "
        f"{tokens // 2} tokens a MoE block): the expert pair differs for {pair_flips} of "
        f"{tokens} token-blocks ({100 * pair_flips / tokens:.3f}%; router margin of those "
        f"<= {flip_gap:.2e}), the capacity keeps another choice for {kept_changes} more (a "
        f"flip shifts its experts' queues); {int(touched.sum())} rows touched, the "
        f"{int(clear.sum())} others at cos >= {cos_min:.6f} card against CPU; all rows cos "
        f">= {float(cos.min()):.6f}; card {t_card:.2f} s, CPU {t_cpu:.2f} s (beside 12d)")
    # bf16 activations on both sides: the router's input rounds elsewhere
    # on the card, so near-tied experts may swap (on an H100: 0.30-0.58% of
    # token-blocks, margins up to 0.034).  At 512 tokens a
    # row nearly every row holds such a token, so every row is held to the
    # CPU's (a swap between near-tied experts moves a row very little)
    check(pair_flips <= 0.01 * tokens and flip_gap <= 0.05,
          f"12a: {pair_flips} of {tokens} expert pairs differ (margins up to {flip_gap})")
    check(cos.min() >= 0.9999 and not cos_min < 0.9999,
          f"12a: rows clear of routing changes {int(clear.sum())}, cos >= {cos_min}, "
          f"all rows cos >= {cos.min()}")
    return dict(params=n_params, chunks=len(sample), tokens=tokens,
                       pair_flips=pair_flips, kept_changes=kept_changes,
                       flip_margin_max=flip_gap, rows_touched=int(touched.sum()),
                       cos_min_clear=cos_min, cos_min_all=float(cos.min()),
                       card_s=t_card, cpu_s=t_cpu)


def phase12b_serving(dev, seed, model, ctx3, p3, p9):
    """12b: phase 3's deployment corpus embedded by the MoE encoder on the
    card, indexed, and phase 3's 16 requests answered by the card's engine
    against a CPU engine over the same embeddings."""
    import numpy as np

    from rag_challenge_2_tpu_torch.index import build_corpus_index
    from rag_challenge_2_tpu_torch.retrieval import QueryEngine, SearchConfig

    reports = make_corpus(np.random.default_rng(seed))
    texts = [c["text"] for r in reports for c in r["content"]["chunks"]]
    embs, t_emb = wall(lambda: model.embed(texts, batch_size=256), dev)
    check(np.isfinite(embs).all(), "12b: non-finite MoE corpus embeddings")
    per_doc, s = [], 0
    for r in reports:
        n = len(r["content"]["chunks"])
        per_doc.append(embs[s:s + n])
        s += n
    idx, meta = build_corpus_index(reports, per_doc, device=dev)
    eng, cpu_eng = QueryEngine(idx, meta), QueryEngine(idx.to("cpu"), meta)
    rate = len(texts) / t_emb
    out = dict(chunks=len(texts), embed_chunks_s=rate,
               dense_chunks_s_phase3=p3["embed_chunks_s"],
               dense_chunks_s_phase9b=p9["pipeline"]["embed_chunks_s"])
    cfgs = {"dense": SearchConfig(method="basic", top_k=30, top_n=30),
            "bm25": SearchConfig(method="basic", top_k=30, top_n=30, use_bm25=True,
                                 bm25_top_k=30)}
    qembs = [model.embed_device(qtexts) for _, qtexts, _, _ in ctx3["requests"]]
    for name, c in cfgs.items():
        zero_counts()
        cands, t = wall(lambda c=c: [
            eng.search(qe, COMPANY, question, years, c, query_texts=qtexts)
            for (question, qtexts, years, _), qe in zip(ctx3["requests"], qembs)], dev)
        launches = {k: v / len(qembs) for k, v in read_counts().items() if v}
        reordered = sum(same_candidates(got, cpu_eng.search(
            qe.cpu(), COMPANY, question, years, c, query_texts=qtexts), 1e-4)
            for got, (question, qtexts, years, _), qe in zip(cands, ctx3["requests"], qembs))
        want = ("dense_topk", "span_gather") if c.use_bm25 else ("dense_topk",)
        check(all(launches.get(k, 0) > 0 for k in want), f"12b {name}: launches {launches}")
        out[name] = dict(launches_per_request=launches, reordered_ties=reordered,
                         ms_per_request=t / len(qembs) * 1e3)
        log(f"12b {name}: 16 requests over the MoE-embedded deployment index == the CPU "
            f"engine (tie groups reordered: {reordered}); launches a request {launches} "
            f"(phase 3's basic + BM25: "
            f"{ {k: v / 32 for k, v in p3['launches'].items()} }); "
            f"{t / len(qembs) * 1e3:.2f} ms a request (search only)")
    log(f"12b: the MoE encoder embedded {len(texts)} chunks in {t_emb:.2f} s = {rate:.0f} "
        f"chunks/s (the dense encoder: phase 3 {p3['embed_chunks_s']:.0f}, 9b "
        f"{p9['pipeline']['embed_chunks_s']:.0f} chunks/s)")
    return out


# 12c's gates, card against CPU in f32 activations: the experts are bf16
# in either type, so an expert's gradients round elsewhere on each device,
# and a near-tied router may pick the other expert
P12C_GATES = (1e-3, 0.999, 1e-3)


def phase12c_step(dev, seed, texts, cfg, weights):
    """12c: one train step of the MoE encoder ``cfg`` (batch 64 x 64) from
    ``weights`` in f32 activations on the card, and in bf16 (the default);
    each step's time beside its bound, and its kernels, launches, busy
    share and top kernels from one profiler window of 10 steps.  Returns
    ``(results, (q, p), cpu_job, finish)``: ``cpu_job()`` takes the f32
    step on the CPU from the same weights (the caller runs it beside 12d)
    and ``finish(cpu_job())`` holds the card's first f32 step against it
    (loss, accuracy, moe_aux, gradient cosines, sure-signed parameters)."""
    import dataclasses

    import numpy as np
    import torch

    from rag_challenge_2_tpu_torch.models.encoder import Encoder, tokenize_batch
    from rag_challenge_2_tpu_torch.models.pretrain import PairSampler, PretrainConfig
    from rag_challenge_2_tpu_torch.models.train import (
        TrainConfig, make_optimizer, make_train_step)
    from rag_challenge_2_tpu_torch.utils.timing import cuda_ms_train

    pre = PretrainConfig(seed=seed)
    qs, ps, _ = PairSampler(texts, pre, device=dev).sample(np.random.default_rng(seed))
    q = torch.from_numpy(tokenize_batch(qs, pre.max_len, cfg.vocab_bits))
    p = torch.from_numpy(tokenize_batch(ps, pre.max_len, cfg.vocab_bits))
    tc = TrainConfig(lr=3e-4)
    out, first = {}, None
    for short, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        c = dataclasses.replace(cfg, dtype=dtype)
        mod = Encoder(c)
        mod.load_state_dict(weights)
        mod.to(dev)
        step = make_train_step(mod, make_optimizer(mod.parameters(), tc), tc)
        qd, pd = q.to(dev), p.to(dev)
        m = step(qd, pd)
        check(all(torch.isfinite(v).item() for v in m.values()), f"12c {short}: {m}")
        if short == "f32":
            # the first step's parameters and gradients, before the timing moves them
            snap = Encoder(c)
            snap.load_state_dict({k: v.cpu() for k, v in mod.state_dict().items()})
            for a, b in zip(snap.parameters(), mod.parameters()):
                a.grad = b.grad.cpu().clone()
            first = ({k: v.cpu() for k, v in m.items()}, snap)
        res = dict(loss=m["loss"].item(), accuracy=m["accuracy"].item(),
                   moe_aux=m["moe_aux"].item())
        ms = cuda_ms_train(lambda: step(qd, pd), n=10, reps=5)
        n_params = sum(t.numel() for t in mod.parameters())
        ops = moe_step_ops(q, p, c, mod)
        bnd = bound(6 * 4 * n_params + 4 * (q.numel() + p.numel()), ops,
                    F32_OPS_S if dtype == torch.float32 else BF16_OPS_S)
        w_ms, d_ms, kernels, launches, top = profile_steps(lambda: step(qd, pd), 10)
        res.update(ms=ms, bound_ms=bnd[0], bound_by=bnd[1], params=n_params,
                   gflop=ops / 1e9, device_kernels=kernels, launch_calls=launches,
                   busy=d_ms / w_ms, top_kernels=top)
        out[short] = res
        log(f"12c {short}: loss {res['loss']:.5f}, accuracy {res['accuracy']:.4f}, moe_aux "
            f"{res['moe_aux']:.5f}; {n_params} parameters, {ops / 1e9:.1f} GFLOP (experts "
            f"at capacity); step {share(ms, bnd)}; {kernels} device kernels a step; busy "
            f"over 10 steps {100 * res['busy']:.1f}%; top kernels a step {top}")
        del mod, step
        torch.cuda.empty_cache()

    cpu_s = []

    def cpu_job():
        t0 = time.perf_counter()
        c = dataclasses.replace(cfg, dtype=torch.float32)
        mod = Encoder(c)
        mod.load_state_dict(weights)
        step = make_train_step(mod, make_optimizer(mod.parameters(), tc), tc)
        m = step(q, p)
        cpu_s.append(time.perf_counter() - t0)
        return m, mod

    def finish(cpu_run):
        res = compare_steps("12c f32", first, cpu_run, False, P12C_GATES)
        aux = (first[0]["moe_aux"].item(), cpu_run[0]["moe_aux"].item())
        check(abs(aux[0] - aux[1]) <= 1e-3 * abs(aux[1]), f"12c f32: moe_aux {aux}")
        log(f"12c f32, card against CPU: loss {res['loss']:.5f} (CPU {res['loss_cpu']:.5f}), "
            f"accuracy {res['accuracy']:.4f} (CPU {res['accuracy_cpu']:.4f}), moe_aux "
            f"{aux[0]:.5f} (CPU {aux[1]:.5f}), gradient cosine >= {res['grad_cos_min']:.6f}, "
            f"{res['params_compared']} parameters compared ({res['params_off']} off, "
            f"{res['params_counted']} counted); the CPU step {cpu_s[0]:.1f} s (beside 12d)")
        return dict(res, moe_aux=aux[0], moe_aux_cpu=aux[1], cpu_s=cpu_s[0])

    return out, (q, p), cpu_job, finish


def rank12_train(dev, b):
    """12d on a rank of a gloo world of 4 on the card: each case's step on
    its mesh against the single-device step on the global batch, both from
    the seed's weights; this rank's shard of every gradient and parameter
    compared; ms a step."""
    import dataclasses

    import torch

    from rag_challenge_2_tpu_torch.models.encoder import Encoder
    from rag_challenge_2_tpu_torch.models.train import TrainConfig, init_training
    from rag_challenge_2_tpu_torch.parallel import make_mesh
    from rag_challenge_2_tpu_torch.parallel.mesh import shard_params

    q, p = b["q"].to(dev), b["p"].to(dev)
    out = {}
    for name, (axes, moe, tc_kw) in b["cases"].items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(b["cfg"], moe_experts=moe)
        tc = TrainConfig(lr=3e-4, **tc_kw)
        gen = torch.Generator().manual_seed(b["seed"])
        ref, _, ref_step = init_training(cfg, tc, dev, gen)
        want = ref_step(q, p)
        mesh = make_mesh(axes, "gloo")
        mod, _, step = init_training(cfg, tc, dev, torch.Generator().manual_seed(b["seed"]),
                                     mesh)
        # the reference's shard of each parameter and of its gradient
        grads = Encoder(cfg)
        grads.load_state_dict({n: t.grad for n, t in ref.named_parameters()})
        shard_params(grads, mesh)
        shard_params(ref, mesh)
        got = step(q, p)
        # the cosine cannot see a scale (a gradient counted once a rank, or
        # 1/W of it): each tensor's norm against the reference's, and a
        # dense case's values within 1e-4 of the tensor's largest
        cos_min, norm_dev, val_err, compared, off = 1.0, 0.0, 0.0, 0, 0
        for (n, gp), rp, rg in zip(mod.named_parameters(), ref.parameters(),
                                   grads.parameters()):
            g, c = gp.grad.double(), rg.detach().to(dev).double()
            if n.endswith(".key.bias"):
                continue
            if c.abs().max() > 0:
                cos_min = min(cos_min, float((g.flatten() @ c.flatten())
                                             / (g.norm() * c.norm())))
                norm_dev = max(norm_dev, abs(float(g.norm() / c.norm()) - 1))
                val_err = max(val_err, float((g - c).abs().max() / c.abs().max()))
            sure = c.abs() >= SIGN_RULE * c.abs().max()
            off += int(((gp.detach() - rp.detach()).abs()[sure] > 1e-6).sum())
            compared += int(sure.sum())
        _, ms = _rank_ms(dev, lambda: step(q, p), 1)
        out[name] = _every(dict(dev=str(dev), loss=got["loss"].item(),
                                loss_ref=want["loss"].item(), aux=got["moe_aux"].item(),
                                aux_ref=want["moe_aux"].item(), cos_min=cos_min,
                                norm_dev=norm_dev, val_err=val_err,
                                compared=compared, off=off, ms=ms,
                                case_s=time.perf_counter() - t0))
        del ref, grads, mod, step, ref_step
        torch.cuda.empty_cache()
    return out


P12_CASES = {
    "dp2xtp2_sp_dense": ({"data": 2, "model": 2}, 0, dict(sequence_parallel=True)),
    "dp2xtp2_sp_moe": ({"data": 2, "model": 2}, P12_EXPERTS, dict(sequence_parallel=True)),
    "dp1xpp4": ({"data": 1, "pipe": 4}, 0, dict(pp_microbatches=2)),
}


def phase12d_sharded(dev, seed, qp, cfg):
    from rag_challenge_2_tpu_torch.parallel import run_ranks

    q, p = qp
    r, t = wall(lambda: run_ranks(rank12_train, 4, "gloo", dev.type, (dict(
        q=q, p=p, seed=seed, cfg=cfg, cases=P12_CASES),), timeout=600), dev)
    out = dict(world_s=t)
    for name, every in r.items():
        e0 = every[0]
        check(all(e["loss"] == e0["loss"] for e in every), f"12d {name}: rank losses differ")
        rel = abs(e0["loss"] - e0["loss_ref"]) / abs(e0["loss_ref"])
        check(rel <= 1e-3, f"12d {name}: loss {e0['loss']} against {e0['loss_ref']}")
        check(all(e["cos_min"] >= 0.9999 for e in every),
              f"12d {name}: gradient cosines {[e['cos_min'] for e in every]}")
        norm_dev = max(e["norm_dev"] for e in every)
        val_err = max(e["val_err"] for e in every)
        check(norm_dev <= 1e-3, f"12d {name}: a gradient's norm is off by {norm_dev}")
        # a dense case in f32 is held by value (bf16 experts round elsewhere)
        check(P12_CASES[name][1] > 0 or val_err <= 1e-4,
              f"12d {name}: a gradient is {val_err} of its largest off")
        compared, off = sum(e["compared"] for e in every), sum(e["off"] for e in every)
        check(off <= 1e-3 * compared, f"12d {name}: {off} of {compared} parameters off")
        out[name] = dict(loss=e0["loss"], loss_single=e0["loss_ref"], loss_rel=rel,
                         moe_aux=e0["aux"], moe_aux_single=e0["aux_ref"],
                         grad_cos_min=min(e["cos_min"] for e in every),
                         grad_norm_dev=norm_dev, grad_err_rel=val_err,
                         params_compared=compared, params_off=off,
                         ms_by_rank=[e["ms"] for e in every], case_s=e0["case_s"])
        log(f"12d {name}: backend gloo, world 4 {P12_CASES[name][0]}, rank devices "
            f"{_devices(every)}: loss {e0['loss']:.5f} against the single-device card step's "
            f"{e0['loss_ref']:.5f} (rel {rel:.2e}), moe_aux {e0['aux']:.5f} / "
            f"{e0['aux_ref']:.5f}, gradient cosine >= {out[name]['grad_cos_min']:.6f}, "
            f"norm within {norm_dev:.1e}, values within {val_err:.1e} of the largest, "
            f"{off} of {compared} sure-signed parameters off; ms a step by rank "
            + ", ".join(f"{e['ms']:.1f}" for e in every)
            + f" ({e0['case_s']:.1f} s for the case); {P11_ONE_CARD}")
    log(f"12d: the world started, ran its three cases and ended in {t:.1f} s")
    return out


def phase12e_start():
    """12e's two subprocesses, started together (each runs beside 12d):
    the dry run on 4 gloo ranks on the card, and ``download-models``."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmds = {"dryrun": ["timeout", "-k", "10", "300", sys.executable, "-m",
                       "rag_challenge_2_tpu_torch.parallel.dryrun", "4", "--device", "cuda"],
            "download_models": ["timeout", "-k", "10", "300", sys.executable, "-m",
                                "rag_challenge_2_tpu_torch", "download-models"]}
    return {k: (subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True), time.perf_counter())
            for k, c in cmds.items()}


def phase12e_finish(procs):
    out = {}
    for name, (proc, t0) in procs.items():
        stdout, stderr = proc.communicate(timeout=330)
        out[name] = dict(s=time.perf_counter() - t0, rc=proc.returncode)
        check(proc.returncode == 0, f"12e {name} failed ({proc.returncode}): {stderr[-2000:]}")
        last = stdout.strip().splitlines()[-1]
        out[name]["line"] = last
        log(f"12e {name} ({out[name]['s']:.1f} s): {last}")
    dr = out["dryrun"]["line"]
    check(dr.startswith("dryrun OK: 4 ranks (gloo, cuda:0)"), f"12e: dry run said {dr}")
    launches = json.loads(dr.split("launches by rank ", 1)[1])
    check(all(r["dense_topk"] > 0 and r["span_gather"] > 0 and r["probe_scores"] > 0
              for r in launches), f"12e: a rank did not launch K1 / K2 / K4: {launches}")
    out["dryrun"]["launches_by_rank"] = launches
    check(out["download_models"]["line"] == "encoder ready: dim=1024",
          f"12e: download-models said {out['download_models']['line']}")
    return out


def phase12_moe(dev, seed, ctx3, ctx9, p3, p9):
    """Phase 12: the MoE encoder and the parallel train step (12a-12e), at
    full width (the default ``EncoderConfig`` with 4 experts).  The CPU
    references of 12a and 12c, and 12e's subprocesses, run beside 12d,
    whose times show correctness, not speed."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from rag_challenge_2_tpu_torch.index.build import load_chunked_reports
    from rag_challenge_2_tpu_torch.models.encoder import Encoder, EncoderConfig
    from rag_challenge_2_tpu_torch.pipeline import PipelineConfig

    log("== phase 12: the MoE encoder and the parallel train step")
    t0 = time.perf_counter()
    texts = [c["text"] for r in load_chunked_reports(PipelineConfig(ctx9["root"]).documents_dir)
             for c in r["content"]["chunks"]]
    cfg = EncoderConfig(moe_experts=P12_EXPERTS)
    marks = [time.perf_counter()]
    # one draw from the seed for 12a and 12c (an encoder keeps f32
    # parameters whatever its activations' type)
    init = Encoder(cfg)
    init.init_weights(torch.Generator().manual_seed(seed))
    weights = init.state_dict()
    model, embed_cpu, embed_finish = phase12a_embed(dev, texts, cfg, weights)
    marks.append(time.perf_counter())
    out = {"serving": phase12b_serving(dev, seed, model, ctx3, p3, p9)}
    del model
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    out["step"], qp, step_cpu, step_finish = phase12c_step(dev, seed, texts, cfg, weights)
    marks.append(time.perf_counter())
    out["part_s"] = {k: b - a for k, a, b in zip(("12a_card", "12b", "12c_card"),
                                                 marks, marks[1:])}
    log("phase 12 so far: " + ", ".join(f"{k} {v:.1f} s" for k, v in out["part_s"].items())
        + "; the CPU references, 12d and 12e run together next")
    with ThreadPoolExecutor(1) as ex:
        jobs = [ex.submit(embed_cpu), ex.submit(step_cpu)]
        procs = phase12e_start()
        # f32 activations: the TP sums and a bf16 router round elsewhere than
        # one device does, which bf16 gates could not tell from a wrong gradient
        out["sharded"] = phase12d_sharded(dev, seed, qp, EncoderConfig(dtype=torch.float32))
        out["cli"] = phase12e_finish(procs)
        out["embed"] = embed_finish(jobs[0].result())
        out["step"]["f32"].update(step_finish(jobs[1].result()))
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 12 took {out['seconds']:.1f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--params", default=None,
                    help="encoder weights npz (reference save_params format)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs the card", file=sys.stderr)
        return 2
    log("== phase 1: environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi: {smi.stderr.strip()}")
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    import numpy as np

    from rag_challenge_2_tpu_torch.device import resolve_device
    from rag_challenge_2_tpu_torch.models.encoder import (
        EmbeddingModel, EncoderConfig, from_jax_params, load_params_npz)

    dev = resolve_device(None)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, count {torch.cuda.device_count()}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    csr = make_csr(dev, gen, 1_500_000)

    k = phase2_kernels(dev, flush, gen, csr)
    del flush
    params = (from_jax_params(load_params_npz(args.params))
              if args.params else None)
    model = EmbeddingModel(EncoderConfig(), params=params, device=dev,
                           generator=torch.Generator().manual_seed(args.seed))
    work = ROOT / "build" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    p3, ctx3 = phase3_main_path(dev, model, np.random.default_rng(args.seed), work)
    p8 = phase8_qa(dev, model, ctx3, card)
    p9, ctx9 = phase9_pipeline(dev, model, args.seed, work)
    del model
    torch.cuda.empty_cache()
    p10 = phase10_training(dev, args.seed, work, ctx9)
    p12 = phase12_moe(dev, args.seed, ctx3, ctx9, p3, p9)
    del ctx9
    torch.cuda.empty_cache()
    p7 = dict(hops=phase7a_hop_shapes(dev, gen), deploy=phase7b_deploy(dev, ctx3),
              batcher=phase7e_batcher(dev, ctx3))
    p4, ctx4 = phase4_scale(dev, gen, csr)
    p7["scale"] = phase7c_scale(dev, ctx4)
    del csr, ctx4
    torch.cuda.empty_cache()
    p5, ctx5 = phase5_ivf(dev, args.seed, ctx3)
    torch.cuda.empty_cache()
    p6, ctx6 = phase6_scan10m(dev, args.seed, ctx3, ctx5)
    p7["int8_10m"] = p6["engine"]["traversal_10m"]
    p11 = phase11_sharded(dev, args.seed, ctx3, ctx6, p6)
    del ctx6
    torch.cuda.empty_cache()

    log("summary " + json.dumps({"phase3": p3, "phase4": p4, "phase5": p5,
                                 "phase6": p6, "phase7": p7, "phase8": p8, "phase9": p9,
                                 "phase10": p10, "phase11": p11, "phase12": p12,
                                 "kernels": k}))
    qa = p8["launches"]
    hyb = p7["deploy"]["hybrid_expansion+bm25"]["launches_per_request"]
    big = [c for c in k["k1"] if c["N"] == 250_000 and c["dtype"] == "bfloat16"][0]
    # phase 9b: launches a pipeline question over its three presets, and
    # each kernel's first call on that path against plain
    p9q = p9["pipeline"]["launches_per_question"]

    def p9err(kernel):
        errs = list(p9["pipeline"]["kernel_errs"].items()) + [
            (f"10{part} {name}", v) for part, ph in (("b", "auto_pretrain"),
                                                     ("c", "device_teacher"),
                                                     ("d", "quality"))
            for name, v in p10[ph]["kernel_errs"].items()]
        return max([v for key, v in errs if key.endswith(" " + kernel)] or [0.0])

    # phase 10: a pipeline question over the auto-pretrained index (10b),
    # an eval_hybrid_e2e question (10b), a device-teacher training step
    # (10c) and one quality eval (10d)
    p10q = p10["auto_pretrain"]["launches_per_question"]
    p10e2e = p10["auto_pretrain"]["e2e_launches_per_question"]
    p10eval = p10["quality"]["launches"]
    # phase 11: one request through the sharded engine, summed over its 4
    # ranks (11d: basic + BM25, and its IVF arm; 11e: the 10M int8 hybrid)
    p11d = p11["engine"]["bm25"]["launches_per_request"]
    p11ivf = p11["engine"]["bm25_ivf"]["launches_per_request"]
    p11e = p11["hybrid"]["launches_per_request"]
    # phase 12: one request over the MoE-embedded deployment index (12b,
    # basic + BM25), and the dry run's launches summed over its 4 ranks (12e)
    p12b = p12["serving"]["bm25"]["launches_per_request"]
    p12e = {name: sum(r[name] for r in p12["cli"]["dryrun"]["launches_by_rank"])
            for name in ("dense_topk", "span_gather", "probe_scores", "stream_topk")}

    kernels_line = {"kernels": [
        {"name": "dense_topk", "route": "cuda",
         "source": "rag_challenge_2_tpu_torch/csrc/dense_topk.cu",
         "replaces": "rag_challenge_2_tpu/ops/pallas_topk.py:142",
         "launches": p3["launches"]["dense_topk"],
         # phase 7b / 7c: the basic block of one hybrid_expansion request
         "launches_per_hybrid_request": hyb["dense_topk"],
         # phase 8: one served QA ask (basic + BM25, 3 routed reports)
         "launches_per_qa_ask": qa["basic"]["dense_topk"],
         "launches_per_pipeline_question": p9q["dense_topk"],
         "launches_per_pretrained_pipeline_question": p10q["dense_topk"],
         "launches_per_e2e_quality_question": p10e2e["dense_topk"],
         "launches_per_quality_eval": p10eval["dense_topk"],
         "launches_per_sharded_request": p11d["dense_topk"],
         "launches_per_moe_request": p12b["dense_topk"],
         "launches_in_dryrun": p12e["dense_topk"],
         "max_abs_err": max(k["k1_err"], p7["hops"]["err"], p9err("dense_topk")),
         "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
         "bound_by": big["bound_by"], "library_ms": big["library_ms"]},
        {"name": "span_gather", "route": "cuda",
         "source": "rag_challenge_2_tpu_torch/csrc/span_gather.cu",
         "replaces": "rag_challenge_2_tpu/ops/pallas_bm25.py:94",
         # both uses: the BM25 arm (phase 3) and the IVF arm (phase 5)
         "launches": p3["launches"]["span_gather"]
         + p5["engine"]["win_start"]["launches"]["span_gather"],
         "launches_per_qa_ask": qa["basic"]["span_gather"],
         "launches_per_pipeline_question": p9q["span_gather"],
         "launches_per_pretrained_pipeline_question": p10q["span_gather"],
         # the device teacher's mining (host_teacher=False)
         "launches_per_training_step": p10["device_teacher"]["k2_per_step"],
         "launches_per_quality_eval": p10eval["span_gather"],
         "launches_per_sharded_request": p11d["span_gather"],
         "launches_per_moe_request": p12b["span_gather"],
         "launches_in_dryrun": p12e["span_gather"],
         "max_abs_err": 0.0,
         # the deployment's BM25 calls (phase 3): G = 8 x 64, W = max_postings
         "shape": f"G={p3['k2']['G']} W={p3['k2']['W']} arrays={p3['k2']['arrays']}",
         "ms": p3["k2"]["ms"], "plain_ms": p3["k2"]["plain_ms"],
         "bound_ms": p3["k2"]["bound_ms"], "bound_by": p3["k2"]["bound_by"],
         "library_ms": p3["k2"]["library_ms"], "parent_ms": p3["k2"]["parent_ms"]},
        {"name": "probe_scores", "route": "cuda",
         "source": "rag_challenge_2_tpu_torch/csrc/probe_scores.cu",
         "replaces": "rag_challenge_2_tpu/ops/pallas_ivf.py:102",
         "launches": p5["engine"]["win_start"]["launches"]["probe_scores"],
         "launches_per_pipeline_question": p9q["probe_scores"],
         "launches_per_sharded_request": p11ivf["probe_scores"],
         "launches_in_dryrun": p12e["probe_scores"],
         "max_abs_err": max(p5["kernels"]["k4_err"], p9err("probe_scores")),
         "ms": p5["kernels"]["float32"]["ms"],
         "plain_ms": p5["kernels"]["float32"]["plain_ms"],
         "bound_ms": p5["kernels"]["float32"]["bound_ms"],
         "bound_by": p5["kernels"]["float32"]["bound_by"],
         "library_ms": p5["kernels"]["float32"]["library_ms"]},
        {"name": "stream_topk", "route": "cuda",
         "source": "rag_challenge_2_tpu_torch/csrc/stream_topk.cu",
         "replaces": "rag_challenge_2_tpu/ops/pallas_topk_stream.py:145",
         # the 10M scans (6b) and the engine's int8 arm at 10M (6c)
         "launches": p6["scans"]["launches"]["stream_topk"]
         + p6["engine"]["hybrid_10m_rtNone"]["launches"]["stream_topk"],
         # phase 9b's int8 preset
         "launches_per_pipeline_question": p9q["stream_topk"],
         "launches_per_sharded_request": p11e["stream_topk"],
         "launches_in_dryrun": p12e["stream_topk"],
         "max_abs_err": max(p6["k3_1m"]["err"], p9err("stream_topk")),
         "ms": p6["k3_10m"]["int8"]["ms"], "plain_ms": p6["k3_10m"]["int8"]["plain_ms"],
         "bound_ms": p6["k3_10m"]["int8"]["bound_ms"],
         "bound_by": p6["k3_10m"]["int8"]["bound_by"],
         "library_ms": p6["k3_10m"]["int8"]["library_ms"]},
    ] + [
        # K3's f32 / bf16 forms at 1M rows, B = 127; their launches on a main
        # path are search_many's 128 stacked queries on the deployment store
        # in that type (6c)
        {"name": f"stream_topk_{short}", "route": "cuda",
         "source": "rag_challenge_2_tpu_torch/csrc/stream_topk.cu",
         "replaces": "rag_challenge_2_tpu/ops/pallas_topk_stream.py:145",
         "launches": p6["engine"][f"search_many_{long}"]["launches"]["stream_topk"],
         # the hops of one hybrid_expansion request: phase 7b's f32 store,
         # phase 7c's bf16 store
         "launches_per_hybrid_request": (
             hyb if short == "f32" else p7["scale"]["launches_per_call"])["stream_topk"],
         # phase 8: one served hybrid_expansion ask on the f32 deployment store
         "launches_per_qa_hybrid_ask": (qa["hybrid_expansion"]["stream_topk"]
                                        if short == "f32" else None),
         # phase 10d: eval_hybrid's 200 stacked queries on an f32 store
         "launches_per_quality_eval": (p10eval["stream_topk"] if short == "f32" else None),
         # 11d's f32 deployment store (8 queries a slot: K1, so 0); no bf16
         # store is on the sharded path
         "launches_per_sharded_request": (p11d["stream_topk"] if short == "f32" else None),
         "max_abs_err": max(p6["k3_1m"][long]["err"], p7["hops"]["err"],
                            p6["engine"][f"search_many_{long}"]["slot_err"]),
         "ms": p6["k3_1m"][long]["ms"], "plain_ms": p6["k3_1m"][long]["plain_ms"],
         "bound_ms": p6["k3_1m"][long]["bound_ms"],
         "bound_by": p6["k3_1m"][long]["bound_by"],
         "library_ms": p6["k3_1m"][long]["library_ms"]}
        for short, long in (("f32", "float32"), ("bf16", "bfloat16"))
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
