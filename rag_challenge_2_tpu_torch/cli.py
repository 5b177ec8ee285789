"""Command line: one-shot retrieval over a saved index.

    python -m rag_challenge_2_tpu_torch query --index PATH --company NAME \
        --question TEXT [--use-bm25] [--top-n 5] [--params ENCODER.npz] \
        [--device cuda|cpu]

Mirrors the reference's ``main.py query``: load the index, embed the
question with the in-repo encoder (random weights from a seed unless a
``save_params`` npz is given), run the routed search and print the top
chunks with their scores.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch


def query(args: argparse.Namespace) -> List[str]:
    from .index.store import load_index
    from .models.encoder import (
        EmbeddingModel, EncoderConfig, from_jax_params, load_params_npz)
    from .retrieval.engine import QueryEngine, SearchConfig

    idx, meta = load_index(args.index, device=args.device)
    if meta is None:
        raise SystemExit(f"{args.index}.meta.json is missing")
    params = (from_jax_params(load_params_npz(args.params))
              if args.params else None)
    model = EmbeddingModel(
        EncoderConfig(), params=params, device=args.device,
        generator=torch.Generator().manual_seed(args.seed),
    )
    eng = QueryEngine(idx, meta)
    cfg = SearchConfig(method="basic", top_n=args.top_n, top_k=args.top_n,
                       use_bm25=args.use_bm25)
    q_emb = model.embed_device([args.question])
    cands = eng.search(q_emb, args.company, args.question, cfg=cfg,
                       query_texts=[args.question])
    return [
        f"[{r['distance']:.4f}] {r['source_sha1']} p{r['page']} "
        f"hits={r['hit_count']} methods={r['method_count']}: {r['text'][:80]}"
        for r in eng.materialize(cands, cfg)
    ]


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="rag_challenge_2_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    q = sub.add_parser("query", help="one-shot retrieval over a saved index")
    q.add_argument("--index", required=True, help="corpus .npz (save_index)")
    q.add_argument("--company", required=True)
    q.add_argument("--question", required=True)
    q.add_argument("--top-n", type=int, default=5)
    q.add_argument("--use-bm25", action="store_true",
                   help="fuse sparse BM25 hits into the dense results")
    q.add_argument("--params", default=None,
                   help="encoder weights npz (reference save_params format)")
    q.add_argument("--seed", type=int, default=0,
                   help="seed of the random encoder weights without --params")
    q.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for line in query(args):
        print(line)


if __name__ == "__main__":
    main()
