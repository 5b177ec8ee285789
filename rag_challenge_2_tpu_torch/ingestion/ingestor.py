"""Chunked reports + embedder → on-device corpus index.

The role of the reference's ``VectorDBIngestor`` / ``BM25Ingestor``
(reference src/ingestion.py): embed every chunk and build the searchable
index.  Differences by design: embeddings come from any callable
(the on-device encoder by default — BASELINE.md config 4 — or a remote
API client), and the output is ONE CorpusIndex npz instead of per-document
faiss/pkl files; the BM25 CSR index is built inside ``build_corpus_index``
from the same chunk texts.

Port of ``rag_challenge_2_tpu/ingestion/ingestor.py``: the embedder is any
callable (``models.encoder.EmbeddingModel.embed`` runs the encoder on the
card), and the index is built with the port's ``index.build`` on
``device``, the card unless the caller names another.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..index import CorpusIndex, CorpusMeta, build_corpus_index, save_index
from ..index.build import load_chunked_reports


class CorpusIngestor:
    def __init__(
        self,
        embedder: Callable[[List[str]], np.ndarray],
        batch_size: int = 512,
        with_sparse: bool = True,
        vocab_bits: int = 20,
        device: DeviceLike = None,
    ):
        self.embedder = embedder
        self.batch_size = batch_size
        self.with_sparse = with_sparse
        self.vocab_bits = vocab_bits
        self.device = resolve_device(device)

    def embed_reports(self, reports: List[Dict]) -> List[np.ndarray]:
        """Batched embedding of every chunk, per document (row order matches
        chunk order — the contract reference src/ingestion.py:79-84 keeps).

        Chunkless documents get a ``(0, D)`` placeholder with the REAL
        embedding dim (build_corpus_index reads dim from the first block,
        so a ``(0, 1)`` placeholder sorting first would poison the corpus
        dim)."""
        out: List[np.ndarray] = []
        empties: List[int] = []
        for rep in reports:
            texts = [c["text"] for c in rep["content"]["chunks"]]
            if texts:
                blocks = [
                    np.asarray(self.embedder(texts[s0 : s0 + self.batch_size]), np.float32)
                    for s0 in range(0, len(texts), self.batch_size)
                ]
                out.append(np.concatenate(blocks) if len(blocks) > 1 else blocks[0])
            else:
                out.append(np.zeros((0, 1), np.float32))
                empties.append(len(out) - 1)
        if empties:
            dims = {e.shape[1] for e in out if e.shape[0] > 0}
            if dims:
                d = dims.pop()
            else:  # every document is empty — probe the embedder once
                d = int(np.asarray(self.embedder(["占位"]), np.float32).shape[1])
            for i in empties:
                out[i] = np.zeros((0, d), np.float32)
        return out

    def build(
        self, reports: List[Dict]
    ) -> Tuple[CorpusIndex, CorpusMeta]:
        embs = self.embed_reports(reports)
        return build_corpus_index(
            reports, embs, with_sparse=self.with_sparse, vocab_bits=self.vocab_bits,
            device=self.device,
        )

    def process_reports(self, chunked_dir: Path, output_path: Path) -> None:
        """Directory of chunked-report JSONs → one index npz (+ sidecar)."""
        reports = load_chunked_reports(Path(chunked_dir))
        idx, meta = self.build(reports)
        save_index(Path(output_path), idx, meta)

    def add_reports(
        self,
        index: CorpusIndex,
        meta: CorpusMeta,
        new_reports: List[Dict],
        new_embeddings: Optional[List[np.ndarray]] = None,
    ) -> Tuple[CorpusIndex, CorpusMeta]:
        """Incremental build (BASELINE.md config 4): embed ONLY the new
        documents on device, splice their rows after the existing corpus,
        and rebuild the cheap host-side parts (metadata columns + CSR term
        index — the native builder makes the CSR rebuild trivial next to
        embedding cost).  Existing embeddings are reused verbatim.
        """
        n_old = index.n_chunks
        if index.emb_scale is not None:
            # int8 store: the raw codes need their per-row scales back —
            # splicing codes next to f32 embeddings would corrupt every
            # score. The rebuilt index is f32; re-quantize afterwards if
            # the int8 memory footprint is wanted (index/store).
            old_emb = (
                index.emb[:n_old].to(torch.float32)
                * index.emb_scale[:n_old, None]
            ).cpu().numpy()
        else:
            old_emb = index.emb[:n_old].to(torch.float32).cpu().numpy()
        old_doc_ids = index.doc_id[:n_old].cpu().numpy()

        # reconstruct per-document embedding blocks in original doc order
        old_blocks = [
            old_emb[old_doc_ids == d] for d in range(index.n_docs)
        ]
        old_reports = _reports_from_meta(index, meta)

        new_embs = (
            [np.asarray(e, np.float32) for e in new_embeddings]
            if new_embeddings is not None
            else self.embed_reports(new_reports)
        )
        return build_corpus_index(
            old_reports + list(new_reports),
            old_blocks + new_embs,
            with_sparse=self.with_sparse,
            vocab_bits=self.vocab_bits,
            device=self.device,
        )


def _reports_from_meta(index: CorpusIndex, meta: CorpusMeta) -> List[Dict]:
    """Reconstruct chunked-report dicts from an index + sidecar (enough
    structure for a rebuild: metainfo, pages, chunks in row order)."""
    n = index.n_chunks
    doc_ids = index.doc_id[:n].cpu().numpy()
    pages_arr = index.page[:n].cpu().numpy()
    kinds = index.kind[:n].cpu().numpy()
    reports: List[Dict] = []
    for d, doc in enumerate(meta.docs):
        page_list = [
            {"page": pg, "text": meta.page_texts.get(seg, "")}
            for seg, (dd, pg) in enumerate(meta.page_seg_info)
            if dd == d
        ]
        chunks = []
        for row in np.nonzero(doc_ids == d)[0]:
            chunks.append({
                "page": int(pages_arr[row]),
                "text": meta.chunk_texts[row],
                "id": len(chunks),
                "type": "serialized_table" if kinds[row] == 1 else "content",
            })
        reports.append({
            "metainfo": {"sha1_name": doc.sha1, "company_name": doc.company,
                         "year": doc.year},
            "content": {"pages": page_list, "chunks": chunks},
        })
    return reports
