"""The system under test: the port's store, engine, batcher and embedding
model, built from a cell's inputs with the port's own public calls.

The rows reach the program as f32 chunks; it keeps them as the
configuration's ``dtype`` states (bf16 by rounding, int8 through its own
``ops.quant.quantize_rows``).  Everything here imports the port lazily,
inside the functions: a checkout without it fails at the first call.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .stores import Store

DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def build_rows(store: Store, wanted: np.ndarray):
    """The store in the configuration's dtype on the device, its row
    scales (int8) or None, and the f32 source rows ``wanted`` (sorted)."""
    from rag_challenge_2_tpu_torch.ops.quant import quantize_rows

    dtype = DTYPES[store.cfg["dtype"]]
    emb = torch.empty((store.n_rows, store.dim), dtype=dtype, device=store.dev)
    scale = (torch.empty(store.n_rows, device=store.dev)
             if dtype == torch.int8 else None)
    src = torch.empty((len(wanted), store.dim), device=store.dev)
    wanted_t = torch.as_tensor(wanted, device=store.dev)
    for s, e, x in store.each_chunk():
        lo, hi = np.searchsorted(wanted, [s, e])
        if hi > lo:
            src[lo:hi] = x[wanted_t[lo:hi] - s]
        if dtype == torch.int8:
            emb[s:e], scale[s:e] = quantize_rows(x)
        else:
            emb[s:e] = x.to(dtype)
        del x
    return emb, scale, src


def build_engine(store: Store, emb: torch.Tensor, scale: Optional[torch.Tensor],
                 csr: Dict[str, object]):
    """A ``QueryEngine`` over the store, its documents and the CSR."""
    from rag_challenge_2_tpu_torch.index.schema import (
        CorpusIndex, CorpusMeta, DocMeta, SparseIndex)
    from rag_challenge_2_tpu_torch.retrieval.engine import QueryEngine

    dev, N = store.dev, store.n_rows
    docs = store.docs()
    doc_id = torch.empty(N, dtype=torch.int32, device=dev)
    for d, doc in enumerate(docs):
        doc_id[doc["start"]:doc["stop"]] = d
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    start = torch.tensor([d["start"] for d in docs], dtype=torch.int32, device=dev)
    years = torch.tensor([d["year"] for d in docs], dtype=torch.int32, device=dev)
    pages = int(store.cfg["pages_per_doc"])
    in_doc = rows - start[doc_id.long()]
    sparse = SparseIndex(
        indptr=csr["indptr"], chunk_ids=csr["chunk_ids"], tf=csr["tf"], df=csr["df"],
        chunk_len=csr["chunk_len"], avgdl=csr["avgdl"], dl=csr["dl"],
        vocab_bits=csr["vocab_bits"], max_postings=csr["W"], dma_pad=csr["pad"])
    index = CorpusIndex(
        emb=emb, doc_id=doc_id, page=in_doc % pages + 1, year=years[doc_id.long()],
        company_id=torch.zeros_like(rows), kind=torch.zeros_like(rows),
        page_seg=doc_id * pages + in_doc % pages, chunk_in_doc=in_doc,
        valid=torch.ones(N, dtype=torch.bool, device=dev), sparse=sparse,
        emb_scale=scale, n_chunks=N, n_pages=pages * len(docs), n_docs=len(docs),
        dim=store.dim)
    meta = CorpusMeta(
        docs=[DocMeta(d["sha1"], d["company"], d["year"], d["stop"] - d["start"], pages)
              for d in docs],
        companies=[store.cfg["company"]], chunk_texts=[], page_texts={},
        page_seg_info=[])
    return QueryEngine(index, meta)


def search_config(mix: dict):
    from rag_challenge_2_tpu_torch.retrieval.engine import SearchConfig

    return SearchConfig(**mix["search"])


def batcher(engine, mix: dict):
    from rag_challenge_2_tpu_torch.serving.batcher import MicroBatcher

    return MicroBatcher(engine, **mix["batcher"])


def dense_topk():
    """The dense layer's public entry."""
    from rag_challenge_2_tpu_torch.ops.topk import dense_topk as entry

    return entry


def int8_store(emb: torch.Tensor):
    """The program's own int8 path over a float store, chunk by chunk: the
    control of a bf16 configuration."""
    from rag_challenge_2_tpu_torch.ops.quant import quantize_rows

    codes = torch.empty(emb.shape, dtype=torch.int8, device=emb.device)
    scale = torch.empty(emb.shape[0], device=emb.device)
    step = 1 << 18
    for s in range(0, emb.shape[0], step):
        codes[s:s + step], scale[s:s + step] = quantize_rows(emb[s:s + step].float())
    return codes, scale


def embedding_model(model: dict, state: Dict[str, torch.Tensor], dev: torch.device):
    """The port's ``EmbeddingModel`` with every key of the configuration's
    ``model.encoder`` passed to its ``EncoderConfig`` (a string
    ``"torch.<name>"`` is that attribute of torch) and the weights
    ``state`` the benchmark made."""
    from rag_challenge_2_tpu_torch.models.encoder import EmbeddingModel, EncoderConfig

    def value(v):
        if isinstance(v, str) and v.startswith("torch."):
            return getattr(torch, v[len("torch."):])
        return v

    cfg = EncoderConfig(**{k: value(v) for k, v in model["encoder"].items()})
    return EmbeddingModel(cfg, params=state, device=dev)


def span_collection():
    """A collection of the port's own spans (``utils/profiling.collect``),
    not yet started."""
    from rag_challenge_2_tpu_torch.utils import profiling

    return profiling.collect()


def kernel_counters() -> Dict[str, int]:
    """The port's launch counters on its kernel wrappers."""
    from rag_challenge_2_tpu_torch.ops.dense_topk import dense_topk_fused
    from rag_challenge_2_tpu_torch.ops.span_gather import gather_posting_spans
    from rag_challenge_2_tpu_torch.ops.stream_topk import stream_topk
    from rag_challenge_2_tpu_torch.ops.topk import wide_topk

    out = {"K1": dense_topk_fused.launches, "K2": gather_posting_spans.launches,
           "K3": stream_topk.launches, "wide_topk": wide_topk.launches}
    out.update({f"K3.{k}": v for k, v in stream_topk.regime_launches.items()})
    return out


def engine_module():
    from rag_challenge_2_tpu_torch.retrieval import engine

    return engine


def build_kernels(names: List[str]) -> None:
    """Build (first run in a checkout) or load the port's CUDA kernels."""
    from rag_challenge_2_tpu_torch.utils import kernels

    kernels.build_all(names)
