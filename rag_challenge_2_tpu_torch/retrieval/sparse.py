"""Standalone BM25 retriever.

Port of ``rag_challenge_2_tpu/retrieval/sparse.py``: route by company and
years, score the routed rows in one masked pass over the corpus CSR index
(``ops.bm25.bm25_scores``), optionally dedup to parent pages, and rank
with the shared fusion op.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..index.schema import CorpusIndex, CorpusMeta
from ..ops.aggregate import fuse_hits
from ..ops.bm25 import bm25_scores, encode_queries_host
from ..ops.topk import NEG_INF
from .routing import route_mask


class BM25Retriever:
    def __init__(self, index: CorpusIndex, meta: CorpusMeta):
        if index.sparse is None:
            raise ValueError("index was built without a sparse term index")
        self.index = index
        self.meta = meta

    @torch.inference_mode()
    def retrieve_by_company_name(
        self,
        company_name: str,
        query: str,
        top_n: int = 3,
        return_parent_pages: bool = False,
        selected_years: Optional[Sequence[int]] = None,
    ) -> List[Dict]:
        cid = self.meta.company_id(company_name)
        if cid < 0:
            raise ValueError(f"No report found with '{company_name}' company name.")
        idx = self.index
        dev = idx.emb.device
        mask = route_mask(idx, cid, selected_years)
        qt = torch.from_numpy(encode_queries_host(
            [query], vocab_bits=idx.sparse.vocab_bits)).to(dev)
        scores = bm25_scores(idx.sparse, qt, idx.n_pad)[0]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))

        rows = torch.arange(idx.n_pad, dtype=torch.int32, device=dev)
        key = idx.page_seg if return_parent_pages else rows
        cands = fuse_hits(
            key, scores, torch.zeros_like(rows), torch.full_like(rows, 3),
            rows, mask & (scores > NEG_INF / 2), top_n=top_n,
        ).to("cpu")
        out = []
        keys = cands.key.numpy()
        vals = cands.base_sim.numpy()
        reps = cands.rep_row.numpy()
        pages = idx.page.cpu().numpy()
        doc_ids = idx.doc_id.cpu().numpy()
        for i in range(len(keys)):
            if keys[i] < 0 or vals[i] <= 0:
                continue
            if return_parent_pages:
                d, pg = self.meta.page_seg_info[int(keys[i])]
                text = self.meta.page_texts.get(int(keys[i]), "")
            else:
                row = int(keys[i])
                d, pg = int(doc_ids[row]), int(pages[row])
                text = self.meta.chunk_texts[row]
            out.append({
                "distance": float(vals[i]),
                "page": int(pg),
                "text": text,
                "source_sha1": self.meta.docs[d].sha1,
                "source_year": self.meta.docs[d].year,
                "rep_row": int(reps[i]),
            })
        return out
