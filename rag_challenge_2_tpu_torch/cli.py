"""Command line: one-shot retrieval over a saved index.

    python -m rag_challenge_2_tpu_torch query --index PATH --company NAME \
        --question TEXT [--use-bm25] [--top-n 5] [--params ENCODER.npz] \
        [--method basic|ssg|triangulation|hybrid_expansion \
         [--max-hops 4] [--neighbor-k 30]] \
        [--use-ivf [--ivf-nprobe 8] [--cluster-order]] \
        [--quantize-int8] [--scan-rt RT] [--device cuda|cpu]

Mirrors the reference's ``main.py query``: load the index, embed the
question with the in-repo encoder (random weights from a seed unless a
``save_params`` npz is given), run the routed search and print the top
chunks with their scores.  With a traversal ``--method`` one more line
follows: the JSON of ``QueryEngine.materialize_details`` (per-anchor
traversal records and, for ``hybrid_expansion``, each method's
contribution).  With ``--use-ivf`` the dense arm probes an IVF
index: the ``<index>.ivf.npz`` sidecar when it was built from this exact
index file (by fingerprint), else one is built on the device and saved.
``--quantize-int8`` serves from the int8 variant of the index
(``index.store.quantize_index``) and ``--scan-rt`` sets
``SearchConfig.scan_rt``: the counterparts of the reference's
``RunConfig.quantize_int8`` / ``scan_rt``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import torch


def query(args: argparse.Namespace) -> List[str]:
    from .index.store import load_index, quantize_index
    from .models.encoder import (
        EmbeddingModel, EncoderConfig, from_jax_params, load_params_npz)
    from .retrieval.engine import QueryEngine, SearchConfig

    idx, meta = load_index(args.index, device=args.device)
    if meta is None:
        raise SystemExit(f"{args.index}.meta.json is missing")
    if args.quantize_int8:
        idx = quantize_index(idx)
    params = (from_jax_params(load_params_npz(args.params))
              if args.params else None)
    model = EmbeddingModel(
        EncoderConfig(), params=params, device=args.device,
        generator=torch.Generator().manual_seed(args.seed),
    )
    eng = QueryEngine(idx, meta)
    if args.use_ivf:
        eng = _with_ivf(eng, Path(args.index), args)
    cfg = SearchConfig(method=args.method, top_n=args.top_n, top_k=args.top_n,
                       max_hops=args.max_hops, neighbor_k=args.neighbor_k,
                       use_bm25=args.use_bm25, use_ivf=args.use_ivf,
                       ivf_nprobe=args.ivf_nprobe, scan_rt=args.scan_rt)
    q_emb = model.embed_device([args.question])
    cands, details = eng.search(q_emb, args.company, args.question, cfg=cfg,
                                query_texts=[args.question], with_details=True)
    lines = [
        f"[{r['distance']:.4f}] {r['source_sha1']} p{r['page']} "
        f"hits={r['hit_count']} methods={r['method_count']}: {r['text'][:80]}"
        for r in eng.materialize(cands, cfg)
    ]
    if args.method != "basic":
        lines.append(json.dumps(eng.materialize_details(details, cfg),
                                ensure_ascii=False))
    return lines


def _with_ivf(eng, index_path: Path, args: argparse.Namespace):
    """Attach the IVF: load the sidecar that matches this index file, or
    build one and save it.  With ``--cluster-order`` the engine then serves
    from the cluster-ordered store (an int8 corpus keeps int8, and the
    sidecar is saved int8 too)."""
    from .index.store import index_fingerprint, load_ivf, save_ivf

    ivf_path = Path(str(index_path) + ".ivf.npz")
    fp = index_fingerprint(index_path)
    ivf = load_ivf(ivf_path, expect_fingerprint=fp, device=args.device)
    if ivf is not None:
        eng.ivf = ivf
    else:
        quant = args.cluster_order and eng.index.emb_scale is not None
        save_ivf(ivf_path, eng.build_ivf(quantize=quant or None), fingerprint=fp)
    return eng.cluster_order() if args.cluster_order else eng


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="rag_challenge_2_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    q = sub.add_parser("query", help="one-shot retrieval over a saved index")
    q.add_argument("--index", required=True, help="corpus .npz (save_index)")
    q.add_argument("--company", required=True)
    q.add_argument("--question", required=True)
    q.add_argument("--top-n", type=int, default=5)
    q.add_argument("--method", default="basic",
                   choices=["basic", "ssg", "triangulation", "hybrid_expansion"])
    q.add_argument("--max-hops", type=int, default=4,
                   help="hops per traversal (ssg, triangulation, hybrid_expansion)")
    q.add_argument("--neighbor-k", type=int, default=30,
                   help="neighbours scored per hop")
    q.add_argument("--use-bm25", action="store_true",
                   help="fuse sparse BM25 hits into the dense results")
    q.add_argument("--params", default=None,
                   help="encoder weights npz (reference save_params format)")
    q.add_argument("--seed", type=int, default=0,
                   help="seed of the random encoder weights without --params")
    q.add_argument("--use-ivf", action="store_true",
                   help="dense arm through the IVF probe (sidecar <index>.ivf.npz)")
    q.add_argument("--ivf-nprobe", type=int, default=8)
    q.add_argument("--cluster-order", action="store_true",
                   help="serve from the IVF's cluster-ordered store (with --use-ivf)")
    q.add_argument("--quantize-int8", action="store_true",
                   help="serve from the int8 variant of the index")
    q.add_argument("--scan-rt", type=float, default=None,
                   help="SearchConfig.scan_rt (accepted; the scan stays exact)")
    q.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for line in query(args):
        print(line)


if __name__ == "__main__":
    main()
