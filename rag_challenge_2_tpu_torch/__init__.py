"""rag_challenge_2_tpu_torch — the retrieval engine in PyTorch + CUDA.

A port of ``rag_challenge_2_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  It keeps the JAX package's module layout and public names so each
counterpart is easy to find, and it never imports jax, flax or the JAX
package: the machine with the card has neither.

Layout (bottom-up):
    device.py   device resolution + the f32 precision settings
    utils/      tokenizer, native CSR/tokenizer bridge, kernel builder
    ops/        dense top-k (kernel K1), posting-span gather (kernel K2),
                the streaming scan with a carried top-k (kernel K3), IVF
                probe span scores (kernel K4), k-means, the int8 and
                centroid-residual stores, BM25 scoring, hit fusion
    index/      index dataclasses, host builder, npz persistence,
                quantize_index, IVF
    retrieval/  routing, graph traversal (ssg, triangulation), the query
                engine (all four methods, hybrid BM25, IVF probe arm,
                f32/bf16/int8 stores, search_many, materialize_details),
                the standalone BM25 retriever, query expansion (HyDE,
                multi-query)
    llm/        prompts, schemas, chat providers (the offline stub among
                them), the answering facade, the reranker (host code)
    qa/         QuestionsProcessor: retrieval → rerank → page selection →
                schema-typed answer, batch runs and submission files
    serving/    the micro-batcher over search_many, the web QA frontend
    ingestion/  PDF / text parsing (the built-in PDF reader among them),
                page merging, token-budgeted chunking, LLM table
                serialization, and the ingestor: chunks → embeddings →
                corpus index, whole or incremental
    pipeline/   the data-set layout, the stage runner and its presets
    eval/       the chunk-to-chunk similarity matrix, the LLM judge, the
                submission scorer, the end-to-end eval over a PDF fixture
    models/     the transformer encoder (inference)
    cli.py      the pipeline's stages, ``query`` (one-shot retrieval) and
                ``serve`` (the web app)
    csrc/       the hand-written CUDA kernels for sm_90a
"""

__version__ = "0.1.0"
