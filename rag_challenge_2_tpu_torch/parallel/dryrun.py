"""The multi-rank dry run: the parallel train step and the sharded search
path on an N-rank world, each checked.

    python -m rag_challenge_2_tpu_torch.parallel.dryrun N \
        [--device cpu|cuda] [--backend gloo|nccl]

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``,
which builds an N-device mesh in one process; here ``parallel/launch``
starts N ranks (gloo ranks on the card by default, every rank on the
one card; ``--device cpu`` runs them on the host, ``--backend nccl``
gives each rank its own card).  Every rank runs, and checks, what the reference checks:

* the dp x tp train step with ``sequence_parallel`` (``data`` N/2 x
  ``model`` 2 when N is even), dense and MoE (experts over ``model``):
  finite losses, the same on every rank;
* dp x pp when N >= 4 and even (``data`` N/2 x ``pipe`` 2, 2
  microbatches): a finite loss;
* ``sharded_dense_topk`` over ``data``: ``[2, 5]`` with every row found;
* the sharded IVF at nprobe = K: the rows of the exact sharded top-k;
* when N >= 4 and even, the two-level merge over ``slice`` 2 x ``device``
  N/2 against the flat merge, and the engine's dense + BM25 + fusion with
  that merge (``QueryEngine(hier=...)``) against the single-device engine;
* the engine's hybrid (dense + BM25 + fusion) over row-sharded dense rows
  and CSR shards, and its probe-served form (a ``ShardedIVF`` at
  nprobe = K), against the single-device engine.

The engines' results are held to the single device's as the reference
holds them, but that rows whose fused scores tie within 1e-4 may come in
another order (the corpus's chunks of a document share their BM25
score; the probe kernel and the scan kernel round the dense score in
another order, so the candidates of a tie arrive in another order).

The reference's hybrid parity also walks ``hybrid_expansion`` over the
sharded store; traversal on a row-sharded store is not ported yet
(``QueryEngine(hier=...)`` raises for it), and the summary says so.
Rank 0 prints one summary line; a failed check ends the run non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .launch import BACKENDS, run_ranks

TINY = dict(vocab_bits=10, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_len=32, out_dim=32)
COMPANY = "金盘科技"


class DryRunError(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise DryRunError(msg)


def _every(x):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def _launches():
    from ..ops.dense_topk import dense_topk_fused
    from ..ops.probe_scores import probe_span_scores
    from ..ops.span_gather import gather_posting_spans
    from ..ops.stream_topk import stream_topk

    return {"dense_topk": dense_topk_fused.launches,
            "span_gather": gather_posting_spans.launches,
            "probe_scores": probe_span_scores.launches,
            "stream_topk": stream_topk.launches}


def _train(dev, mesh, cfg_kw, tc_kw, q, d):
    from ..models.encoder import EncoderConfig
    from ..models.train import TrainConfig, init_training

    _, _, step = init_training(EncoderConfig(**TINY, **cfg_kw), TrainConfig(**tc_kw),
                               dev, mesh=mesh)
    loss = step(q, d)["loss"].item()
    _check(np.isfinite(loss), f"non-finite loss {loss} ({cfg_kw}, {tc_kw})")
    _check(len(set(_every(loss))) == 1, "the ranks' losses differ")
    return loss


def _reports(n_docs, per_doc, rng, texts):
    reports, embs = [], []
    for d in range(n_docs):
        pages = [{"page": p + 1, "text": f"doc{d} page{p + 1}"} for p in range(4)]
        chunks = [{"page": c * 4 // per_doc + 1, "text": texts(d, c), "id": c,
                   "type": "content"} for c in range(per_doc)]
        reports.append({"metainfo": {"sha1_name": f"J{2022 + d}_doc{d}",
                                     "company_name": COMPANY, "year": 2022 + d},
                        "content": {"pages": pages, "chunks": chunks}})
        e = rng.normal(size=(per_doc, 32)).astype(np.float32)
        embs.append(e / np.linalg.norm(e, axis=1, keepdims=True))
    return reports, embs


def _same(got, base, what, counts=False, tol=1e-4):
    """``got`` equals ``base`` (materialized results): fused scores within
    ``tol`` position by position, and the same rows but for the order
    inside a group of scores tied within ``tol`` (the engines' stable
    sorts keep the order their candidates came in, and a probe-served or
    sharded path brings them in another; the last group, cut by ``top_n``,
    may hold other rows).  Returns the number of tie groups reordered."""
    gr, br = [r["rep_row"] for r in got], [r["rep_row"] for r in base]
    gd, bd = [r["distance"] for r in got], [r["distance"] for r in base]
    detail = f"{what}: got {list(zip(gr, gd))}, want {list(zip(br, bd))}"
    _check(len(gr) == len(br) and all(abs(a - b) <= tol for a, b in zip(gd, bd)),
           f"{what}: fused scores differ ({detail})")
    reordered, i = 0, 0
    while i < len(br):
        j = i + 1
        while j < len(br) and abs(bd[j] - bd[j - 1]) <= 2 * tol:
            j += 1
        if j < len(br):
            _check(set(gr[i:j]) == set(br[i:j]), f"{what}: other rows ({detail})")
            reordered += gr[i:j] != br[i:j]
        i = j
    if counts:
        want = {r["rep_row"]: r["method_count"] for r in base}
        _check(all(want.get(r["rep_row"], r["method_count"]) == r["method_count"]
                   for r in got), f"{what}: a method count differs ({detail})")
    return reordered


def _sharded_engine(idx, meta, mesh, grid, sparse, ivf=None):
    from ..parallel.sharded_search import shard_rows
    from ..parallel.sharded_sparse import shard_sparse_index
    from ..retrieval import QueryEngine

    S = mesh.size()
    mine = dataclasses.replace(
        idx, emb=shard_rows(idx.emb, mesh, grid),
        sparse=shard_sparse_index(idx.sparse, S, mesh, grid) if sparse else idx.sparse)
    return QueryEngine(mine, meta, ivf=ivf, hier=(mesh, *grid))


def _engine_hier_parity(dev, mesh):
    """Dense + BM25 + fusion with the dense stage on the two-level merge
    (``slice`` x ``device``) against the single-device engine."""
    from ..index import build_corpus_index
    from ..retrieval import QueryEngine, SearchConfig

    n = mesh.size()
    per_doc = 16 * ((n + 15) // 16)
    while (3 * per_doc) % n:
        per_doc += 1
    reports, embs = _reports(3, per_doc, np.random.default_rng(11),
                             lambda d, c: f"doc{d} {COMPANY} 营业收入 chunk{c}")
    idx, meta = build_corpus_index(reports, embs, vocab_bits=12, device=dev)
    q = embs[1][3][None, :]
    cfg = SearchConfig(method="basic", top_k=5, top_n=10, use_bm25=True)
    base_eng = QueryEngine(idx, meta)
    base = base_eng.materialize(
        base_eng.search(q, COMPANY, cfg=cfg, query_texts=["营业收入"]), cfg)
    eng = _sharded_engine(idx, meta, mesh, ("slice", "device"), sparse=False)
    return _same(eng.materialize(eng.search(q, COMPANY, cfg=cfg, query_texts=["营业收入"]),
                                 cfg), base, "the two-level merge in the engine")


def _hybrid_sharded_parity(dev, n):
    """The hybrid over row-sharded dense rows and CSR shards (a flat mesh
    of n shards), and its probe-served form, against the single device."""
    from ..index import build_corpus_index
    from ..retrieval import QueryEngine, SearchConfig
    from .mesh import make_mesh
    from .sharded_ivf import build_sharded_ivf

    reports, embs = _reports(3, 12, np.random.default_rng(7),
                             lambda d, c: f"doc{d} {COMPANY} 营业收入 毛利率 chunk{c}")
    idx, meta = build_corpus_index(reports, embs, vocab_bits=12, device=dev)
    q = np.concatenate(embs)[5][None, :]
    cfg = SearchConfig(method="basic", top_k=5, top_n=10, use_bm25=True)
    base_eng = QueryEngine(idx, meta)
    base = base_eng.materialize(
        base_eng.search(q, COMPANY, cfg=cfg, query_texts=["营业收入"]), cfg)
    grid = ("slice", "device")
    mesh = make_mesh({"slice": 1, "device": n})
    eng = _sharded_engine(idx, meta, mesh, grid, sparse=True)
    got = eng.materialize(eng.search(q, COMPANY, cfg=cfg, query_texts=["营业收入"]), cfg)
    reordered = _same(got, base, "the sharded hybrid", counts=True)
    kc = 2
    sivf = build_sharded_ivf(idx.emb, mesh, n_clusters=kc, iters=4, valid=idx.valid,
                             axis=grid)
    eng_ivf = _sharded_engine(idx, meta, mesh, grid, sparse=True, ivf=sivf)
    cfg_ivf = dataclasses.replace(cfg, use_ivf=True, ivf_nprobe=kc)
    got_ivf = eng_ivf.materialize(
        eng_ivf.search(q, COMPANY, cfg=cfg_ivf, query_texts=["营业收入"]), cfg_ivf)
    reordered += _same(got_ivf, base, "the sharded probe-served hybrid")
    return (f"OK ({len(got)} fused rows + probe-served {len(got_ivf)} rows, {n} CSR+dense "
            f"shards, tie groups reordered {reordered}; hybrid_expansion on a row-sharded "
            f"store: not ported, ROADMAP A.14f)")


def dryrun_rank(dev: torch.device, n: int) -> dict:
    """The dry run on one rank of an ``n``-rank world."""
    from .mesh import make_mesh
    from .sharded_ivf import build_sharded_ivf, sharded_ivf_search
    from .sharded_search import hierarchical_dense_topk, sharded_dense_topk

    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = make_mesh({"data": dp, "model": tp})
    rng = np.random.default_rng(0)
    B = max(dp * 2, 4)
    q = torch.from_numpy(rng.integers(0, 1 << TINY["vocab_bits"], (B, 16)).astype(np.int32))
    d = torch.from_numpy(rng.integers(0, 1 << TINY["vocab_bits"], (B, 16)).astype(np.int32))
    out = {"mesh": {"data": dp, "model": tp}}
    out["dense_loss"] = _train(dev, mesh, {}, dict(sequence_parallel=True), q, d)
    out["moe_loss"] = _train(dev, mesh, dict(moe_experts=4),
                             dict(sequence_parallel=True), q, d)
    out["pp_loss"] = float("nan")
    if n >= 4 and n % 2 == 0:
        pp = make_mesh({"data": n // 2, "pipe": 2})
        out["pp_loss"] = _train(dev, pp, {}, dict(pp_microbatches=2), q, d)

    emb = torch.from_numpy(rng.normal(size=(dp * 64, 32)).astype(np.float32)).to(dev)
    qv = torch.from_numpy(rng.normal(size=(2, 32)).astype(np.float32)).to(dev)
    vals, rows = sharded_dense_topk(qv, emb, 5, mesh)
    _check(tuple(vals.shape) == (2, 5) and bool((rows >= 0).all()),
           "sharded_dense_topk: a row is missing")

    ivf_mesh = make_mesh({"data": n})
    emb_ivf = torch.from_numpy(rng.normal(size=(n * 64, 32)).astype(np.float32)).to(dev)
    emb_ivf = emb_ivf / emb_ivf.norm(dim=1, keepdim=True)
    sivf = build_sharded_ivf(emb_ivf, ivf_mesh, n_clusters=4, iters=4)
    _, ivf_rows = sharded_ivf_search(sivf, qv, 5, ivf_mesh, nprobe=4)
    _, want_rows = sharded_dense_topk(qv, emb_ivf, 5, ivf_mesh)
    _check(ivf_rows.tolist() == want_rows.tolist(),
           "sharded IVF with nprobe=K must equal the exact distributed top-k")

    out["hier"] = "skipped (n < 4 or odd)"
    if n >= 4 and n % 2 == 0:
        hier_mesh = make_mesh({"slice": 2, "device": n // 2})
        _, hi = hierarchical_dense_topk(qv, emb_ivf, 5, hier_mesh)
        _check(hi.tolist() == want_rows.tolist(),
               "hierarchical two-level merge diverged from the flat merge")
        reordered = _engine_hier_parity(dev, hier_mesh)
        out["hier"] = (f"OK (2 slices x {n // 2} devices, standalone + engine graph, tie "
                       f"groups reordered {reordered})")
    out["hybrid"] = _hybrid_sharded_parity(dev, n)
    out["launches"] = _every(_launches())
    out["devices"] = _every(str(dev))
    return out


def summary_line(r: dict, n: int, backend: str) -> str:
    m = r["mesh"]
    return (f"dryrun OK: {n} ranks ({backend}, {', '.join(sorted(set(r['devices'])))}), "
            f"mesh data={m['data']} model={m['model']} (dp x tp x sp x ep + pp), "
            f"dense loss={r['dense_loss']:.4f}, moe loss={r['moe_loss']:.4f}, "
            f"pp loss={r['pp_loss']:.4f}, sharded top-k + sharded IVF (nprobe=K "
            f"exactness) verified, hierarchical merge parity: {r['hier']}, hybrid "
            f"dense+bm25+fusion sharded parity: {r['hybrid']}; launches by rank "
            + json.dumps(r["launches"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--backend", default="gloo", choices=list(BACKENDS))
    args = ap.parse_args(argv)
    resolve_device(args.device)
    # by its module's name, not __main__'s: each rank imports it afresh
    from rag_challenge_2_tpu_torch.parallel.dryrun import dryrun_rank as rank_fn

    r = run_ranks(rank_fn, args.n, args.backend, args.device, (args.n,))
    print(summary_line(r, args.n, args.backend), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
