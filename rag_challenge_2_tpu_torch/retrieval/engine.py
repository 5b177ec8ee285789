"""The query engine: routed hybrid retrieval, basic method.

Port of ``rag_challenge_2_tpu/retrieval/engine.py`` for ``method="basic"``
with or without BM25 fusion.  One request fans out over (query, routed
document) pairs; dense candidates come from kernel K1 per routed document
slot, or with ``use_ivf`` from one IVF probe search over all pairs
(``index.ivf.ivf_search``: kernels K4 and K2), BM25 candidates from
``ops.bm25.bm25_topk`` (kernel K2 in front), and
``ops.aggregate.fuse_hits`` applies the reference's bonuses.

Queries are padded to ``max_queries`` and routed documents to
``max_docs`` like the reference, so the fused hit lists keep its shapes;
unrouted slots are skipped on the host (no device round-trip: the engine
keeps host copies of the routing columns).
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..index.ivf import (IVFIndex, build_ivf, cluster_order_index,
                         ivf_search, quantize_ivf)
from ..index.schema import CorpusIndex, CorpusMeta
from ..ops.aggregate import FusedCandidates, fuse_hits
from ..ops.topk import NEG_INF, dense_topk

METHOD_IDS = {"basic": 0, "ssg": 1, "triangulation": 2, "bm25": 3}

_NOT_PORTED = {
    "ssg": "graph traversal is not ported yet (ROADMAP A.10)",
    "triangulation": "graph traversal is not ported yet (ROADMAP A.10)",
    "hybrid_expansion": "graph traversal is not ported yet (ROADMAP A.10)",
}


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Retrieval configuration; the same fields and defaults as the
    reference's ``SearchConfig``."""

    method: str = "basic"
    top_k: int = 30                 # per-(query, doc) candidates for `basic`
    max_hops: int = 4
    neighbor_k: int = 30
    max_queries: int = 8
    max_docs: int = 8
    return_parent_pages: bool = False
    top_n: int = 30                 # final aggregated candidate count
    # hybrid BM25 fusion: sparse hits join the dense ones as their own
    # method; BM25 scores are max-normalized per query
    use_bm25: bool = False
    bm25_top_k: int = 30
    # cross-method fusion rule (ops/aggregate.fuse_hits): "max" or "sum"
    fuse_mode: str = "max"
    # scales every non-BM25 arm's sims before fusion (with use_bm25)
    dense_weight: float = 1.0
    use_ivf: bool = False
    ivf_nprobe: int = 8
    scan_rt: Optional[float] = None


def _check_supported(cfg: SearchConfig) -> None:
    if cfg.method in _NOT_PORTED:
        raise NotImplementedError(f"method={cfg.method!r}: {_NOT_PORTED[cfg.method]}")
    if cfg.method != "basic":
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.scan_rt is not None:
        raise NotImplementedError(
            "scan_rt: approximate top-k is not ported yet (ROADMAP A.11)")


def _bm25_texts(query_texts, question: str, max_q: int) -> List[str]:
    """BM25 text list for one request, padded to ``max_q``; falsy
    ``query_texts`` fall back to the question text."""
    texts = list(query_texts or [question])[:max_q]
    return texts + [""] * (max_q - len(texts))


@dataclasses.dataclass
class Request:
    """One routed, padded request: what :func:`search_device` consumes.
    Host copies sit beside the device tensors so unrouted slots are
    skipped without a device round-trip."""

    q: torch.Tensor                  # [Q, D] f32 padded query embeddings
    q_valid: torch.Tensor            # [Q] bool
    doc_masks: torch.Tensor          # [M, N] bool routed row masks
    doc_valid: np.ndarray            # [M] bool (host)
    q_terms: Optional[torch.Tensor]  # [Q, T] BM25 term ids, -1 padded
    row_slot: torch.Tensor           # [N] i32 doc slot per row (M = unrouted)
    win_start: np.ndarray            # [M] i32 doc row-range starts (host)
    win_len: np.ndarray              # [M] i32 doc row-range lengths (host)
    slot_doc: Optional[np.ndarray] = None  # [M] i32 routed doc per slot, -1 pad


Block = Tuple[torch.Tensor, ...]     # (rows, sims, qids, mids, valid)


@torch.inference_mode()
def dense_hits(index: CorpusIndex, req: Request, cfg: SearchConfig,
               window: int = 0) -> Block:
    """Per-(query, doc) dense top-k through kernel K1, ``[Q*M, k]`` with
    p = q*M + m.

    Windowed corpora (``window > 0``: docs are contiguous row ranges)
    score each routed slot's rows ``emb[start : start + len]`` alone, so
    the store read shrinks to the routed fraction; ragged corpora (or
    ``M * window`` over twice the corpus) score the whole store per slot
    under the slot's row mask.  Either way the mask is shared by the
    slot's queries; padded queries are dropped afterwards."""
    q = req.q
    Q = q.shape[0]
    M, N = req.doc_masks.shape
    dev = q.device
    k = min(cfg.top_k, N)
    vals = torch.full((Q, M, k), NEG_INF, dtype=torch.float32, device=dev)
    rows = torch.zeros((Q, M, k), dtype=torch.int32, device=dev)
    windowed = window > 0 and window >= k and M * window <= 2 * N
    for m in range(M):
        if not req.doc_valid[m]:
            continue
        if windowed:
            ws, wl = int(req.win_start[m]), int(req.win_len[m])
            if wl == 0:
                continue
            v, r = dense_topk(q, index.emb[ws : ws + wl], k)
            r = r + ws
        else:
            v, r = dense_topk(q, index.emb, k, mask=req.doc_masks[m])
        vals[:, m, : v.shape[1]] = v
        rows[:, m, : r.shape[1]] = r
    vals = torch.where(req.q_valid[:, None, None], vals,
                       torch.full_like(vals, NEG_INF)).reshape(Q * M, k)
    rows = rows.reshape(Q * M, k)
    ok = vals > NEG_INF / 2
    sims = torch.where(ok, vals, torch.zeros_like(vals))
    qids = _qid_pair(Q, M, dev)[:, None].expand(rows.shape)
    mids = torch.full(rows.shape, METHOD_IDS["basic"], dtype=torch.int32,
                      device=dev)
    return rows, sims, qids, mids, ok


def _qid_pair(Q: int, M: int, dev) -> torch.Tensor:
    return torch.arange(Q, dtype=torch.int32, device=dev).repeat_interleave(M)


@torch.inference_mode()
def ivf_hits(index: CorpusIndex, ivf: IVFIndex, req: Request,
             cfg: SearchConfig, window: int = 0) -> Block:
    """Per-(query, doc) IVF probe top-k over all ``Q*M`` pairs in one
    :func:`~..index.ivf.ivf_search` (kernels K4 and K2), ``[Q*M, k_eff]``
    with p = q*M + m and ``k_eff = min(top_k, nprobe * max_list)``.

    The routing mode is the cheapest one the index allows, in the
    reference's order: doc equality on a cluster-ordered corpus
    (``slot_doc`` and ``ivf.cluster_doc``), row ranges on a windowed
    corpus whose IVF has list bounds, else the ``[Q*M, N]`` pair mask."""
    q = req.q
    Q = q.shape[0]
    M = req.doc_masks.shape[0]
    dev = q.device
    q_pair = q.repeat_interleave(M, dim=0)
    qv_rep = req.q_valid.repeat_interleave(M)
    dv = torch.as_tensor(req.doc_valid, dtype=torch.bool, device=dev)
    kw = dict(k=cfg.top_k, nprobe=cfg.ivf_nprobe)
    if req.slot_doc is not None and ivf.cluster_doc is not None:
        sd = torch.as_tensor(req.slot_doc, dtype=torch.int32, device=dev).repeat(Q)
        pd = torch.where(qv_rep, sd, torch.full_like(sd, -1))
        vals, rows = ivf_search(ivf, q_pair, pair_doc=pd, pos_doc=index.doc_id,
                                **kw)
    elif window > 0 and ivf.list_row_min is not None:
        ws = torch.as_tensor(req.win_start, dtype=torch.int32, device=dev).repeat(Q)
        wl = torch.as_tensor(req.win_len, dtype=torch.int32, device=dev).repeat(Q)
        wl = torch.where(qv_rep & dv.repeat(Q), wl, torch.zeros_like(wl))
        vals, rows = ivf_search(ivf, q_pair, win_start=ws, win_len=wl, **kw)
    else:
        pair_mask = (req.doc_masks[None, :, :] & req.q_valid[:, None, None]
                     & dv[None, :, None]).reshape(Q * M, -1)
        vals, rows = ivf_search(ivf, q_pair, mask=pair_mask, **kw)
    ok = vals > NEG_INF / 2
    sims = torch.where(ok, vals, torch.zeros_like(vals))
    qids = _qid_pair(Q, M, dev)[:, None].expand(rows.shape)
    mids = torch.full(rows.shape, METHOD_IDS["basic"], dtype=torch.int32,
                      device=dev)
    return rows, sims, qids, mids, ok


@torch.inference_mode()
def bm25_hits(index: CorpusIndex, req: Request, cfg: SearchConfig,
              window: int = 0) -> Block:
    """Per-(query, doc) BM25 top-k (kernel K2 in front), scores
    max-normalized per QUERY over all its doc slots (a per-pair max would
    lift every routed doc's best lexical hit to 1.0)."""
    from ..ops.bm25 import bm25_topk

    Q = req.q.shape[0]
    M, N = req.doc_masks.shape
    dev = req.q.device
    k_bm = min(cfg.bm25_top_k, N)
    ws_t = wl_t = None
    if window > 0:
        ws_t = torch.as_tensor(req.win_start, dtype=torch.int32, device=dev)
        wl_t = torch.as_tensor(req.win_len, dtype=torch.int32, device=dev)
    bv_mqk, brows_mqk, ok_mqk = bm25_topk(
        index.sparse, req.q_terms, req.doc_masks, k_bm,
        row_slot=req.row_slot, win_start=ws_t, win_len=wl_t,
    )
    # [M, Q, k] → [Q*M, k] with row index q*M + m
    bv = bv_mqk.transpose(0, 1).reshape(Q * M, k_bm)
    brows = brows_mqk.transpose(0, 1).reshape(Q * M, k_bm)
    ok_b = ok_mqk.transpose(0, 1).reshape(Q * M, k_bm)
    dv = torch.as_tensor(req.doc_valid, dtype=torch.bool, device=dev)
    ok_b = ok_b & req.q_valid.repeat_interleave(M)[:, None] & dv.repeat(Q)[:, None]
    per_q = torch.where(ok_b, bv, torch.zeros_like(bv)).reshape(
        Q, M * k_bm).amax(dim=1)
    norm = per_q.clamp(min=1e-9).repeat_interleave(M)[:, None]
    sims_b = torch.where(ok_b, bv / norm, torch.zeros_like(bv))
    qids_b = _qid_pair(Q, M, dev)[:, None].expand(brows.shape)
    mids_b = torch.full(brows.shape, METHOD_IDS["bm25"], dtype=torch.int32,
                        device=dev)
    return brows, sims_b, qids_b, mids_b, ok_b


@torch.inference_mode()
def fuse_blocks(index: CorpusIndex, blocks: Sequence[Block],
                cfg: SearchConfig) -> FusedCandidates:
    """Flatten the arms' hits, weight the non-BM25 arms, key by chunk row
    or parent page, and fuse."""
    rows_f, sims_f, qids_f, mids_f, valid_f = (
        torch.cat([b[i].reshape(-1) for b in blocks]) for i in range(5))
    valid_f = valid_f & (rows_f >= 0)
    if cfg.use_bm25 and cfg.dense_weight != 1.0:
        sims_f = torch.where(mids_f == METHOD_IDS["bm25"], sims_f,
                             sims_f * cfg.dense_weight)
    safe_rows = rows_f.clamp(min=0).long()
    key_f = index.page_seg[safe_rows] if cfg.return_parent_pages else safe_rows
    return fuse_hits(key_f, sims_f, qids_f, mids_f, rows_f, valid_f,
                     top_n=cfg.top_n, mode=cfg.fuse_mode)


def search_device(
    index: CorpusIndex, req: Request, cfg: SearchConfig, window: int = 0,
    ivf: Optional[IVFIndex] = None,
) -> Tuple[FusedCandidates, Dict]:
    """Full fan-out + aggregation for one request on ``index``'s device:
    dense hits (IVF probe hits with ``use_ivf``), BM25 hits (with
    ``use_bm25``), fusion.  Returns ``(fused_candidates, details)``;
    ``details`` is empty for the basic method, as in the reference."""
    _check_supported(cfg)
    if cfg.use_ivf:
        if ivf is None:
            raise ValueError("SearchConfig.use_ivf requires an IVFIndex "
                             "(QueryEngine.build_ivf() first)")
        blocks = [ivf_hits(index, ivf, req, cfg, window)]
    else:
        blocks = [dense_hits(index, req, cfg, window)]
    if cfg.use_bm25 and req.q_terms is not None and index.sparse is not None:
        blocks.append(bm25_hits(index, req, cfg, window))
    return fuse_blocks(index, blocks, cfg), {}


class QueryEngine:
    """Host-side orchestration around :func:`search_device`.

    Owns the corpus index (on its device) and metadata, routes on host
    copies of the routing columns, and materialises candidates into the
    reference's result-dict shape.
    """

    def __init__(self, index: CorpusIndex, meta: CorpusMeta,
                 ivf: Optional[IVFIndex] = None, hier=None):
        if ivf is not None and not isinstance(ivf, IVFIndex):
            raise NotImplementedError(
                "ivf must be an IVFIndex; the sharded IVF is not ported yet "
                "(ROADMAP A.14)")
        if hier is not None:
            raise NotImplementedError(
                "the multi-device merge is not ported yet (ROADMAP A.14)")
        self.index = index
        self.meta = meta
        # optional clustered index for SearchConfig(use_ivf=True)
        self.ivf = ivf
        self.device = index.emb.device
        self._doc_ids_np = index.doc_id.cpu().numpy()
        self._valid_np = index.valid.cpu().numpy()
        self._page_np = index.page.cpu().numpy()
        live_docs = set(np.unique(self._doc_ids_np[self._valid_np]).tolist())
        self._doc_company_np = np.asarray([
            meta.companies.index(d.company) if d.company in meta.companies
            else -1 for d in meta.docs
        ], np.int32)
        self._doc_year_np = np.asarray(
            [d.year if d.year is not None else -1 for d in meta.docs], np.int32)
        self._doc_valid_np = np.asarray(
            [i in live_docs for i in range(len(meta.docs))], bool)
        self._mask_cache: Dict[tuple, tuple] = {}
        # concurrent callers share one engine: cache ops take this lock
        self._cache_lock = threading.Lock()
        # per-doc contiguous row ranges; window = 0 if any doc is fragmented
        self._doc_ranges: Dict[int, Tuple[int, int]] = {}
        self.window = 0
        longest = 0
        vrows = np.flatnonzero(self._valid_np)
        if vrows.size:
            vdocs = self._doc_ids_np[vrows]
            cuts = np.flatnonzero(np.diff(vdocs)) + 1
            starts = np.concatenate(([0], cuts))
            ends = np.concatenate((cuts, [vrows.size]))
            seen: set = set()
            ok = True
            for s0, e0 in zip(starts, ends):
                d = int(vdocs[s0])
                if d in seen:        # doc appears in two runs → fragmented
                    ok = False
                    break
                seen.add(d)
                first, last = int(vrows[s0]), int(vrows[e0 - 1])
                if last - first + 1 != e0 - s0:  # holes inside the run
                    ok = False
                    break
                self._doc_ranges[d] = (first, e0 - s0)
                longest = max(longest, e0 - s0)
            if not ok:
                self._doc_ranges = {}
                longest = 0
        if longest:
            self.window = min(-(-longest // 128) * 128, index.n_pad)

    def build_ivf(self, quantize: Optional[bool] = None, **kwargs) -> IVFIndex:
        """Cluster the corpus on its device for ``use_ivf`` queries
        (``kwargs`` go to ``index.ivf.build_ivf``).  An int8 corpus is
        dequantized for clustering (k-means on raw codes would use the
        wrong geometry); ``quantize=True`` then re-quantizes the IVF to
        int8, otherwise the probe store stays f32."""
        emb = self.index.emb
        if self.index.emb_scale is not None:
            emb = emb.float() * self.index.emb_scale[:, None]
            self.ivf = build_ivf(emb, valid=self.index.valid, **kwargs)
            if quantize:
                self.ivf = quantize_ivf(self.ivf)
        else:
            self.ivf = build_ivf(emb, valid=self.index.valid, **kwargs)
        return self.ivf

    def cluster_order(self, **build_kwargs) -> "QueryEngine":
        """A new engine over the corpus rearranged into IVF cluster order
        (``index.ivf.cluster_order_index``): one row store serves the probe
        and the flat paths.  Builds the IVF first if absent.  An int8
        corpus keeps its int8 budget: the IVF is re-quantized before its
        buffer becomes the corpus.  Documents are then fragmented, so the
        new engine's window is 0 and IVF routing is by doc equality."""
        if self.ivf is None:
            self.build_ivf(**build_kwargs)
        ivf = self.ivf
        if self.index.emb_scale is not None and ivf.emb_perm.dtype != torch.int8:
            ivf = quantize_ivf(ivf)
        new_idx, new_meta, new_ivf = cluster_order_index(self.index, self.meta, ivf)
        return QueryEngine(new_idx, new_meta, ivf=new_ivf)

    # -- routing ---------------------------------------------------------
    def routed_docs(
        self,
        company: Optional[str],
        question: str = "",
        selected_years: Optional[Sequence[int]] = None,
    ) -> List[int]:
        """Doc ids matching the (company, years) route, in doc order."""
        from .routing import route_core

        cid = self.meta.company_id(company) if company is not None else None
        if company is not None and cid < 0:
            raise ValueError(f"No report found with '{company}' company name.")
        mask = route_core(
            np, self._doc_valid_np, self._doc_company_np, self._doc_year_np,
            cid, selected_years,
        )
        return np.flatnonzero(mask).tolist()

    def doc_masks(self, doc_ids: Sequence[int], max_docs: int) -> tuple:
        """``(masks [M, N] bool, valid [M] host, row_slot [N] i32,
        win_start [M] host, win_len [M] host, slot_doc [M] host)`` for a
        route; masks and row_slot on the device.  An LRU of 16 routes."""
        if len(doc_ids) > max_docs:
            # keep the newest documents (by year, then doc id)
            doc_ids = sorted(
                doc_ids,
                key=lambda d: (self.meta.docs[d].year or -1, d),
                reverse=True,
            )[:max_docs]
            doc_ids = sorted(doc_ids)
            warnings.warn(
                f"route matched more than max_docs={max_docs} documents; "
                f"keeping the newest {max_docs} (raise SearchConfig.max_docs "
                "to search all)",
                stacklevel=2,
            )
        key = (tuple(doc_ids), max_docs)
        with self._cache_lock:
            cached = self._mask_cache.get(key)
            if cached is not None:
                self._mask_cache[key] = self._mask_cache.pop(key)  # LRU refresh
                return cached
        n_pad = self.index.n_pad
        m = np.zeros((max_docs, n_pad), bool)
        v = np.zeros((max_docs,), bool)
        slot = np.full((n_pad,), max_docs, np.int32)
        ws = np.zeros((max_docs,), np.int32)
        wl = np.zeros((max_docs,), np.int32)
        sd = np.full((max_docs,), -1, np.int32)
        for i, d in enumerate(doc_ids):
            m[i] = self._valid_np & (self._doc_ids_np == d)
            slot[m[i]] = i
            v[i] = True
            sd[i] = d
            if d in self._doc_ranges:
                ws[i], wl[i] = self._doc_ranges[d]
        out = (
            torch.from_numpy(m).to(self.device), v,
            torch.from_numpy(slot).to(self.device), ws, wl, sd,
        )
        with self._cache_lock:
            self._mask_cache[key] = out
            while len(self._mask_cache) > 16:
                self._mask_cache.pop(next(iter(self._mask_cache)))
        return out

    # -- search ----------------------------------------------------------
    def _pad_request(self, query_embs, max_q: int):
        """One request's ``[B, D]`` embeddings (numpy or tensor) →
        padded ``([max_q, D] f32, [max_q] bool)`` on the device."""
        qe = torch.as_tensor(query_embs)
        B = min(qe.shape[0], max_q)
        q = torch.zeros((max_q, self.index.dim), dtype=torch.float32,
                        device=self.device)
        q[:B] = qe[:B].to(device=self.device, dtype=torch.float32)
        qv = torch.arange(max_q, device=self.device) < B
        return q, qv

    def prepare(
        self,
        query_embs,
        company: Optional[str],
        question: str = "",
        selected_years: Optional[Sequence[int]] = None,
        cfg: SearchConfig = SearchConfig(),
        query_texts: Optional[Sequence[str]] = None,
    ) -> Request:
        """Route one request and pad it: ``[B, D]`` query embeddings (numpy
        or tensor) and, with ``use_bm25``, the BM25 term ids."""
        doc_ids = self.routed_docs(company, question, selected_years)
        if not doc_ids:
            raise ValueError(f"No report found with '{company}' company name.")
        dm, dv, row_slot, ws, wl, sd = self.doc_masks(doc_ids, cfg.max_docs)
        q, qv = self._pad_request(query_embs, cfg.max_queries)
        q_terms = None
        if cfg.use_bm25 and self.index.sparse is not None:
            from ..ops.bm25 import encode_queries_host

            texts = _bm25_texts(query_texts, question, cfg.max_queries)
            q_terms = torch.from_numpy(encode_queries_host(
                texts, vocab_bits=self.index.sparse.vocab_bits)).to(self.device)
        return Request(q, qv, dm, dv, q_terms, row_slot, ws, wl, sd)

    def search(
        self,
        query_embs,
        company: Optional[str],
        question: str = "",
        selected_years: Optional[Sequence[int]] = None,
        cfg: SearchConfig = SearchConfig(),
        query_texts: Optional[Sequence[str]] = None,
        with_details: bool = False,
    ) -> FusedCandidates:
        """Run the fan-out for one request of ``[B, D]`` query embeddings
        (numpy or tensor)."""
        req = self.prepare(query_embs, company, question, selected_years,
                           cfg, query_texts)
        cands, details = search_device(self.index, req, cfg, self.window,
                                       ivf=self.ivf if cfg.use_ivf else None)
        return (cands, details) if with_details else cands

    def search_many(self, *args, **kwargs):
        raise NotImplementedError(
            "search_many (micro-batched requests) is not ported yet "
            "(ROADMAP A.9)")

    # -- materialisation -------------------------------------------------
    def materialize(
        self, cands: FusedCandidates, cfg: SearchConfig
    ) -> List[Dict]:
        """Candidates → reference-shaped result dicts.  With
        ``cfg.dense_weight != 1.0`` the ``distance``/``base_similarity`` of
        dense-only keys are the weighted scores, as in the reference."""
        c = cands.to("cpu")
        keys = c.key.numpy()
        scores = c.score.numpy()
        base = c.base_sim.numpy()
        nq = c.n_queries.numpy()
        nm = c.n_methods.numpy()
        rep = c.rep_row.numpy()
        out = []
        for i in range(len(keys)):
            if keys[i] < 0:
                continue
            if cfg.return_parent_pages:
                d, pg = self.meta.page_seg_info[int(keys[i])]
                text = self.meta.page_texts.get(int(keys[i]), "")
            else:
                row = int(keys[i])
                d = int(self._doc_ids_np[row])
                pg = int(self._page_np[row])
                text = (self.meta.chunk_texts[row]
                        if row < len(self.meta.chunk_texts) else "")
            out.append({
                "distance": float(scores[i]),
                "base_similarity": float(base[i]),
                "page": int(pg),
                "text": text,
                "source_sha1": self.meta.docs[d].sha1,
                "source_year": self.meta.docs[d].year,
                "hit_count": int(nq[i]),
                "method_count": int(nm[i]),
                "rep_row": int(rep[i]),
            })
        return out
