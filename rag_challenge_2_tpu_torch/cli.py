"""Command line: the pipeline's stages, one-shot retrieval and the web QA
server.

The stages of the JAX package's ``main.py``, with the same options and
defaults, over a data-set root (``<root>/pdf_reports``, ``subset.csv``,
``questions.json``; ``pipeline.paths``) and a named preset
(``pipeline.run.configs``)::

    python -m rag_challenge_2_tpu_torch download-models [--device cuda]
    python -m rag_challenge_2_tpu_torch parse-pdfs [--root data/test_set] \
        [--config base] [--parallel|--sequential] [--chunk-size 2] \
        [--max-workers 10] [--parser auto|docling|builtin]
    python -m rag_challenge_2_tpu_torch serialize-tables [--root R] [--config C] \
        [--max-workers 5]
    python -m rag_challenge_2_tpu_torch process-reports [--root R] [--config C]
    python -m rag_challenge_2_tpu_torch process-questions [--root R] \
        [--config qwen] [--use-hyde|--no-hyde] [--use-multi-query|--no-multi-query]
    python -m rag_challenge_2_tpu_torch train-encoder [--root R] [--config base] \
        [--steps 200] [--batch-size 64] [--out PARAMS.npz]
    python -m rag_challenge_2_tpu_torch eval-encoder [--ict-steps 5000] \
        [--supervised-steps 2000] [--batch-size 64] [--out RESULTS.json]
    python -m rag_challenge_2_tpu_torch analyze-similarity [--root R] \
        [--config C] [--doc 0] [--out DIR]
    python -m rag_challenge_2_tpu_torch rank --submissions-dir DIR \
        --answers FILE [--max-questions 60] [--csv-out FILE]

Every command that touches tensors takes ``--device`` (``cuda`` by
default, ``cpu`` for the plain versions).  ``train-encoder`` pretrains
the encoder on the root's chunked reports (``models/pretrain.py``) and
saves its weights, by default to ``<root>/databases/encoder_params.npz``;
``download-models`` downloads nothing (the encoder is local): it builds
the CUDA kernels into ``build/kernels/`` when the device is the card and
embeds one text, as ``main.py``'s warms its local models.
``process-reports`` embeds with that file when it exists, and without it
pretrains an encoder first (``RAGTPU_AUTO_PRETRAIN_STEPS``, 300 by
default; ``RAGTPU_AUTO_PRETRAIN=0`` indexes with the seeded random
weights).  ``eval-encoder`` runs the encoder quality experiment
(``eval/encoder_quality.run_quality_eval``) and prints its results as one
JSON line.

``query`` and ``serve`` take either a root (``--root --config``, as
``main.py``: the root's index and encoder params) or a saved index::

    python -m rag_challenge_2_tpu_torch query (--index PATH | [--root R] \
        [--config base]) --company NAME --question TEXT [--use-bm25] \
        [--top-n 5] [--params ENCODER.npz] \
        [--method basic|ssg|triangulation|hybrid_expansion \
         [--max-hops 4] [--neighbor-k 30]] \
        [--use-ivf [--ivf-nprobe 8] [--cluster-order]] \
        [--quantize-int8] [--scan-rt RT] [--device cuda|cpu]

    python -m rag_challenge_2_tpu_torch serve (--index PATH | [--root R] \
        [--config qwen]) [--params ENCODER.npz] [--company 金盘科技] \
        [--method M] [--use-bm25] [--llm-reranking] [--micro-batch N] \
        [--provider NAME] [--host 127.0.0.1] [--port 8899] [--device cuda|cpu]

``query`` loads the index, embeds the question with the in-repo encoder
(random weights from a seed unless a ``save_params`` npz is given), runs
the routed search and prints the top chunks with their scores.  With a
traversal ``--method`` one more line follows: the JSON of
``QueryEngine.materialize_details`` (per-anchor traversal records and, for
``hybrid_expansion``, each method's contribution).  With ``--use-ivf`` the
dense arm probes an IVF index: the ``<index>.ivf.npz`` sidecar when it was
built from this exact index file (by fingerprint), else one is built on
the device and saved.  ``--quantize-int8`` serves from the int8 variant of
the index (``index.store.quantize_index``) and ``--scan-rt`` sets
``SearchConfig.scan_rt``: the counterparts of the reference's
``RunConfig.quantize_int8`` / ``scan_rt``.

``serve`` is the web QA frontend (``serving.webapp.QAWebApp``).  Over a
root it serves ``Pipeline.build_processor`` of the preset, whose flags
``--method``, ``--use-bm25``, ``--llm-reranking``, ``--micro-batch`` and
``--provider`` override when given.  Over ``--index`` it builds a
``QuestionsProcessor`` on the loaded index with the encoder's ``embed`` and
the chat provider ``--provider`` names (``stub``, the offline provider, by
default; the others read their endpoint and key from the environment).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import torch

METHODS = ["basic", "ssg", "triangulation", "hybrid_expansion"]


def _pipeline(args: argparse.Namespace, **overrides):
    """The root's ``Pipeline`` under a copy of the named preset (overrides
    must not change the shared registry entry); None overrides are not
    applied."""
    from .pipeline import Pipeline, configs

    run_config = dataclasses.replace(
        configs[args.config],
        **{k: v for k, v in overrides.items() if v is not None})
    return Pipeline(Path(args.root), run_config, device=args.device)


def _index_and_params(args: argparse.Namespace):
    """``--index`` / ``--params`` as given, else the root's index and its
    saved encoder params (when the file exists)."""
    if args.index is not None:
        return Path(args.index), args.params
    paths = _pipeline(args).paths
    saved = paths.databases_path / "encoder_params.npz"
    return paths.index_path, args.params or (saved if saved.exists() else None)


def _encoder(params, device, seed: int):
    from .models.encoder import (
        EmbeddingModel, EncoderConfig, from_jax_params, load_params_npz)

    weights = from_jax_params(load_params_npz(params)) if params else None
    return EmbeddingModel(EncoderConfig(), params=weights, device=device,
                          generator=torch.Generator().manual_seed(seed))


def query(args: argparse.Namespace) -> List[str]:
    from .index.store import load_index, quantize_index
    from .retrieval.engine import QueryEngine, SearchConfig

    index_path, params = _index_and_params(args)
    idx, meta = load_index(index_path, device=args.device)
    if meta is None:
        raise SystemExit(f"{index_path}.meta.json is missing")
    if args.quantize_int8:
        idx = quantize_index(idx)
    model = _encoder(params, args.device, args.seed)
    eng = QueryEngine(idx, meta)
    if args.use_ivf:
        eng = _with_ivf(eng, index_path, args)
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


def build_server(args: argparse.Namespace):
    """The ``serve`` command's HTTP server (not yet serving): over a root,
    the preset's ``Pipeline.build_processor``, as ``main.py serve`` builds
    it; over ``--index``, the index, the encoder and the provider as
    ``query`` builds them."""
    from .serving import QAWebApp

    if args.index is None:
        pipe = _pipeline(
            args, retrieval_method=args.method, api_provider=args.provider,
            use_bm25_db=args.use_bm25 or None,
            llm_reranking=args.llm_reranking or None,
            micro_batch=args.micro_batch or None)
        app = QAWebApp(pipe.build_processor(), default_company=args.company,
                       pdf_dir=pipe.paths.pdf_reports_dir)
        return app.make_server(args.host, args.port)

    from .index.store import load_index
    from .llm import LLMFacade, LLMReranker, get_provider
    from .qa import QAConfig, QuestionsProcessor
    from .retrieval.engine import QueryEngine

    idx, meta = load_index(args.index, device=args.device)
    if meta is None:
        raise SystemExit(f"{args.index}.meta.json is missing")
    # random weights from seed 0 without --params, as `query` by default
    model = _encoder(args.params, args.device, 0)
    provider = get_provider(args.provider or "stub")
    cfg = QAConfig(retrieval_method=args.method or "basic",
                   use_bm25=args.use_bm25, llm_reranking=args.llm_reranking,
                   micro_batch=args.micro_batch)
    processor = QuestionsProcessor(
        QueryEngine(idx, meta), model.embed, LLMFacade(provider),
        LLMReranker(provider) if args.llm_reranking else None, cfg)
    app = QAWebApp(processor, default_company=args.company)
    return app.make_server(args.host, args.port)


def run_stage(args: argparse.Namespace) -> List[str]:
    """The ``main.py`` stages; returns the lines to print."""
    cmd = args.command
    if cmd == "download-models":
        from .models.encoder import EmbeddingModel, EncoderConfig

        if torch.device(args.device).type == "cuda":
            from .utils.kernels import build_all

            build_all()
        emb = EmbeddingModel(EncoderConfig(), device=args.device).embed(["warmup 预热"])
        return [f"encoder ready: dim={emb.shape[1]}"]
    if cmd == "parse-pdfs":
        _pipeline(args).parse_pdf_reports(
            parallel=args.parallel, chunk_size=args.chunk_size,
            max_workers=args.max_workers, parser=args.parser)
        return ["parsed"]
    if cmd == "serialize-tables":
        _pipeline(args).serialize_tables(max_workers=args.max_workers)
        return ["serialized"]
    if cmd == "process-reports":
        _pipeline(args).process_parsed_reports()
        return ["index built"]
    if cmd == "process-questions":
        result = _pipeline(args, use_hyde=args.use_hyde,
                           use_multi_query=args.use_multi_query).process_questions()
        return [json.dumps(result["statistics"], ensure_ascii=False)]
    if cmd == "train-encoder":
        from .index.build import load_chunked_reports
        from .models.pretrain import PretrainConfig, pretrain_encoder, save_params

        p = _pipeline(args)
        reports = load_chunked_reports(p.paths.documents_dir)
        texts = [c["text"] for r in reports for c in r["content"]["chunks"]]
        model, stats = pretrain_encoder(
            texts, pre_cfg=PretrainConfig(steps=args.steps, batch_size=args.batch_size),
            device=args.device)
        out = args.out or (p.paths.databases_path / "encoder_params.npz")
        save_params(model, out)
        return [json.dumps({"params": str(out), **stats["final"]}, ensure_ascii=False)]
    if cmd == "eval-encoder":
        from .eval.encoder_quality import run_quality_eval

        res = run_quality_eval(
            ict_steps=args.ict_steps, supervised_steps=args.supervised_steps,
            batch_size=args.batch_size, log=lambda m: print(m, flush=True),
            device=args.device)
        line = json.dumps(res, ensure_ascii=False)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(line)
        return [line]
    if cmd == "analyze-similarity":
        from .eval.similarity import analyze_document
        from .index import load_index

        p = _pipeline(args)
        idx, meta = load_index(p.paths.index_path, device=args.device)
        out = args.out or (p.paths.databases_path / "similarity")
        return [json.dumps(analyze_document(idx, meta, args.doc, output_dir=out),
                           ensure_ascii=False)]
    if cmd == "rank":
        from .eval import rank_submissions

        scores = rank_submissions(
            Path(args.submissions_dir), Path(args.answers),
            max_questions=args.max_questions,
            csv_out=Path(args.csv_out) if args.csv_out else None)
        return [f"{i + 1}. {s.submission_name or s.file_name}: "
                f"score={s.score:.2f} (val {s.val_score:.1f} + ref {s.ref_score:.1f}/2)"
                for i, s in enumerate(scores)]
    return query(args)


def _root_options(p: argparse.ArgumentParser, config: str) -> None:
    p.add_argument("--root", default="data/test_set",
                   help="data-set root (pdf_reports/, subset.csv, questions.json)")
    p.add_argument("--config", default=config,
                   help="named preset of pipeline.run.configs")


def _switch(p: argparse.ArgumentParser, on: str, off: str, dest: str,
            default=None) -> None:
    """A ``--on/--off`` pair of flags setting ``dest`` (click's form)."""
    p.add_argument(on, dest=dest, action="store_const", const=True, default=default)
    p.add_argument(off, dest=dest, action="store_const", const=False)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="rag_challenge_2_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    s = sub.add_parser("download-models",
                       help="warm the local models: build the kernels, embed one text")
    s.add_argument("--device", default="cuda")

    s = sub.add_parser("parse-pdfs", help="PDF/TXT reports → parsed-report JSONs")
    _root_options(s, "base")
    _switch(s, "--parallel", "--sequential", "parallel", default=False)
    s.add_argument("--chunk-size", type=int, default=2)
    s.add_argument("--max-workers", type=int, default=10)
    s.add_argument("--parser", default="auto", choices=["auto", "docling", "builtin"],
                   help="auto = docling when installed, else the built-in "
                        "parser (.txt + digital-text .pdf via minipdf)")
    s.add_argument("--device", default="cuda")

    s = sub.add_parser("serialize-tables", help="LLM table serialization over parsed reports")
    _root_options(s, "base")
    s.add_argument("--max-workers", type=int, default=5)
    s.add_argument("--device", default="cuda")

    s = sub.add_parser("process-reports",
                       help="merge → markdown → chunk → build the corpus index")
    _root_options(s, "base")
    s.add_argument("--device", default="cuda")

    s = sub.add_parser("process-questions", help="answer questions.json against the index")
    _root_options(s, "qwen")
    _switch(s, "--use-hyde", "--no-hyde", "use_hyde")
    _switch(s, "--use-multi-query", "--no-multi-query", "use_multi_query")
    s.add_argument("--device", default="cuda")

    s = sub.add_parser("train-encoder",
                       help="self-supervised (ICT) encoder pretraining on the chunked corpus")
    _root_options(s, "base")
    s.add_argument("--steps", type=int, default=200)
    s.add_argument("--batch-size", type=int, default=64)
    s.add_argument("--out", default=None,
                   help="params npz (default <databases>/encoder_params.npz)")
    s.add_argument("--device", default="cuda")

    s = sub.add_parser("eval-encoder",
                       help="encoder retrieval-quality experiment (BASELINE config 4)")
    s.add_argument("--ict-steps", type=int, default=5000)
    s.add_argument("--supervised-steps", type=int, default=2000)
    s.add_argument("--batch-size", type=int, default=64)
    s.add_argument("--out", default=None, help="write results json here")
    s.add_argument("--device", default="cuda")

    s = sub.add_parser("analyze-similarity",
                       help="chunk-to-chunk cosine matrix + stats for one document")
    _root_options(s, "base")
    s.add_argument("--doc", type=int, default=0, help="document id")
    s.add_argument("--out", default=None,
                   help="output dir (default <databases>/similarity)")
    s.add_argument("--device", default="cuda")

    s = sub.add_parser("rank", help="score submissions against canonical answers")
    s.add_argument("--submissions-dir", required=True)
    s.add_argument("--answers", required=True,
                   help="canonical answers JSON (question -> {kind, answers, "
                        "reference_pools})")
    s.add_argument("--max-questions", type=int, default=60)
    s.add_argument("--csv-out", default=None)

    q = sub.add_parser("query", help="one-shot retrieval over a saved index")
    _root_options(q, "base")
    q.add_argument("--index", default=None,
                   help="corpus .npz (save_index) in place of the root's")
    q.add_argument("--company", required=True)
    q.add_argument("--question", required=True)
    q.add_argument("--top-n", type=int, default=5)
    q.add_argument("--method", default="basic", choices=METHODS)
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

    s = sub.add_parser("serve", help="the web QA frontend")
    _root_options(s, "qwen")
    s.add_argument("--index", default=None,
                   help="corpus .npz (save_index) in place of a root")
    s.add_argument("--params", default=None,
                   help="encoder weights npz (reference save_params format)")
    s.add_argument("--company", default="金盘科技",
                   help="the company of questions that name none")
    s.add_argument("--method", default=None, choices=METHODS,
                   help="the default retrieval method (the web form may change it)")
    s.add_argument("--use-bm25", action="store_true",
                   help="fuse sparse BM25 hits into the dense results")
    s.add_argument("--llm-reranking", action="store_true",
                   help="rerank the retrieved pages with the LLM")
    s.add_argument("--micro-batch", type=int, default=0,
                   help="coalesce concurrent same-route searches into one "
                        "stacked dispatch of at most N requests (0 = off)")
    s.add_argument("--provider", default=None,
                   help="chat provider: stub (offline; the default with "
                        "--index), qwen, openai, dashscope or gemini")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8899)
    s.add_argument("--device", default="cuda")
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.command == "serve":
        server = build_server(args)
        host, port = server.server_address[:2]
        print(f"QA web app listening on http://{host}:{port}", flush=True)
        try:
            server.serve_forever()
        finally:
            server.server_close()
        return
    for line in run_stage(args):
        print(line, flush=True)


if __name__ == "__main__":
    main()
