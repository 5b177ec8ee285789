"""The query engine: routed hybrid retrieval, all four methods.

Port of ``rag_challenge_2_tpu/retrieval/engine.py``.  One request fans out
over (query, routed document) pairs; dense candidates come per routed
document slot from ``ops.topk.dense_topk`` (kernel K1 for f32 / bf16
stores and up to 64 queries, kernel K3 for int8 stores and larger
batches), or with ``use_ivf`` from one IVF probe search over all pairs
(``index.ivf.ivf_search``: kernels K4 and K2), BM25 candidates from
``ops.bm25.bm25_topk`` (kernel K2 in front), and ``ops.aggregate.fuse_hits``
applies the reference's bonuses.  ``search_many`` stacks the queries of R
requests that share a route, so each routed slot of the store is read
once per micro-batch, and fuses per request.

Methods (``method=``):
  * ``basic``            per-(query, doc) exact top-k
  * ``ssg``              anchor top-1 + greedy chunk-similarity hops
  * ``triangulation``    anchor top-1 + centroid-scored hops
  * ``hybrid_expansion`` basic top-50 ∪ SSG(top-10 anchors) ∪
                         Tri(top-20 anchors)

The traversal methods walk per routed document slot
(``retrieval/traversal.py``): all walkers of a slot share the slot's rows,
so on an f32 / bf16 store every hop is one ``dense_topk`` call (K1 up to
64 walkers, K3 above).

The sharded form (BASELINE config 5 over a world of ranks, ``parallel/``)
runs on every rank: ``hier=(mesh, slice_axis, dev_axis)`` with a
row-sharded store sends the basic dense stage through the two-level
merge, a ``ShardedSparseIndex`` merges BM25 over its CSR shards, and a
``ShardedIVF`` probes each rank's own IVF; fusion and materialisation run
alike on every rank.  Traversal needs every rank's rows and raises there.

Queries are padded to ``max_queries`` and routed documents to
``max_docs`` like the reference, so the fused hit lists keep its shapes;
unrouted slots are skipped on the host (no device round-trip: the engine
keeps host copies of the routing columns).  ``scan_rt`` is accepted and
the scan stays exact (``ops/topk.py``).
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
from ..index.schema import CorpusIndex, CorpusMeta, ShardedSparseIndex
from ..ops.aggregate import FusedCandidates, fuse_hits
from ..ops.topk import NEG_INF, dense_topk
from ..parallel.mesh import axis_index
from ..parallel.sharded_ivf import ShardedIVF, sharded_ivf_search
from ..parallel.sharded_search import make_hierarchical_topk
from ..parallel.sharded_sparse import sharded_bm25_topk
from .traversal import (CAND_RECORD, TraversalResult, emit_hits, traverse,
                        traverse_windowed)

METHOD_IDS = {"basic": 0, "ssg": 1, "triangulation": 2, "bm25": 3}
METHODS = ("basic", "ssg", "triangulation", "hybrid_expansion")

# hybrid-expansion shape constants
HYBRID_BASIC_K = 50
HYBRID_SSG_ANCHORS = 10
HYBRID_TRI_ANCHORS = 20

# The JAX engine copies each document's rows for its windowed traversal and
# budgets those copies with this cap; its walkers come back in (slot, query,
# anchor) order when a window fits the cap and in (query, slot, anchor)
# order otherwise.  The port walks views of the store whenever the corpus
# is windowed and copies nothing: the cap is kept only because it decides
# that order, which ``materialize_details`` shows.
TRAVERSAL_WINDOW_COPY_CAP = 4 << 30


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
               window: int = 0, k: Optional[int] = None) -> Block:
    """Per-(query, doc) dense top-k (kernel K1, or K3 for an int8 store or
    more than 64 queries), ``[Q*M, k]`` with p = q*M + m; ``k`` defaults
    to ``cfg.top_k``.

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
    k = min(cfg.top_k if k is None else k, N)
    vals = torch.full((Q, M, k), NEG_INF, dtype=torch.float32, device=dev)
    rows = torch.zeros((Q, M, k), dtype=torch.int32, device=dev)
    windowed = window > 0 and window >= k and M * window <= 2 * N
    scale = index.emb_scale                  # [N] f32 iff the store is int8
    for m in range(M):
        if not req.doc_valid[m]:
            continue
        if windowed:
            ws, wl = int(req.win_start[m]), int(req.win_len[m])
            if wl == 0:
                continue
            v, r = dense_topk(q, index.emb[ws : ws + wl], k, row_scale=None
                              if scale is None else scale[ws : ws + wl])
            r = r + ws
        else:
            v, r = dense_topk(q, index.emb, k, mask=req.doc_masks[m],
                              row_scale=scale)
        vals[:, m, : v.shape[1]] = v
        rows[:, m, : r.shape[1]] = r
    vals = torch.where(req.q_valid[:, None, None], vals,
                       torch.full_like(vals, NEG_INF)).reshape(Q * M, k)
    return _basic_block(vals, rows.reshape(Q * M, k), Q, M)


def _basic_block(vals: torch.Tensor, rows: torch.Tensor, Q: int, M: int) -> Block:
    """A ``[Q*M, k]`` dense (or probe) top-k as the basic method's block."""
    dev = vals.device
    ok = vals > NEG_INF / 2
    sims = torch.where(ok, vals, torch.zeros_like(vals))
    qids = _qid_pair(Q, M, dev)[:, None].expand(rows.shape)
    mids = torch.full(rows.shape, METHOD_IDS["basic"], dtype=torch.int32,
                      device=dev)
    return rows, sims, qids, mids, ok


def _qid_pair(Q: int, M: int, dev) -> torch.Tensor:
    return torch.arange(Q, dtype=torch.int32, device=dev).repeat_interleave(M)


@torch.inference_mode()
def hier_dense_hits(index: CorpusIndex, req: Request, cfg: SearchConfig, hier,
                    window: int = 0, k: Optional[int] = None) -> Block:
    """:func:`dense_hits` on a row-sharded store (``hier = (mesh,
    slice_axis, dev_axis)``): ``index.emb`` / ``emb_scale`` hold only this
    rank's rows of the padded store (``parallel.shard_rows`` over the
    flattened (slice, device) grid), every other column is replicated.
    Each rank scores its rows of each routed slot with the kernels, then
    the two-level merge (``parallel.make_hierarchical_topk``, pair mode)
    gives every rank the ``[Q*M, k]`` block of the single-device engine.
    Called on every rank of the mesh."""
    mesh, s_ax, d_ax = hier
    q = req.q
    Q = q.shape[0]
    M, N = req.doc_masks.shape
    k = min(cfg.top_k if k is None else k, N)
    rps = index.emb.shape[0]
    int8 = index.emb_scale is not None
    kern = make_hierarchical_topk(mesh, k, s_ax, d_ax, int8=int8, pair_mask=True)
    rest = (index.emb_scale,) if int8 else ()
    if window > 0 and window >= k and M * window <= 2 * N:
        # windowed corpora: each slot scores its row range within this rank
        vals, rows = kern(q, index.emb, req.doc_masks, req.q_valid, req.doc_valid,
                          *rest, win_start=req.win_start, win_len=req.win_len)
    else:
        lo = axis_index(mesh, (s_ax, d_ax)) * rps
        masks = req.doc_masks[:, lo: lo + rps]
        if masks.shape[1] < rps:                 # the padded tail of the store
            masks = torch.nn.functional.pad(masks, (0, rps - masks.shape[1]))
        vals, rows = kern(q, index.emb, masks.contiguous(), req.q_valid,
                          req.doc_valid, *rest)
    return _basic_block(vals, rows, Q, M)


@torch.inference_mode()
def ivf_hits(index: CorpusIndex, ivf: IVFIndex, req: Request,
             cfg: SearchConfig, window: int = 0, k: Optional[int] = None) -> Block:
    """Per-(query, doc) IVF probe top-k over all ``Q*M`` pairs in one
    :func:`~..index.ivf.ivf_search` (kernels K4 and K2), ``[Q*M, k_eff]``
    with p = q*M + m and ``k_eff = min(k, nprobe * max_list)``; ``k``
    defaults to ``cfg.top_k``.

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
    kw = dict(k=cfg.top_k if k is None else k, nprobe=cfg.ivf_nprobe)
    if isinstance(ivf, ShardedIVF):
        # the distributed probe: contiguous original-row windows only; with
        # no window layout a mask mode would be needed, and searching the
        # whole corpus instead would break routing
        if window <= 0:
            raise ValueError(
                "ShardedIVF requires the contiguous doc-window layout "
                "(index/build) — rebuild the corpus index or route with "
                "win_start/win_len")
        ws = torch.as_tensor(req.win_start, dtype=torch.int32, device=dev).repeat(Q)
        wl = torch.as_tensor(req.win_len, dtype=torch.int32, device=dev).repeat(Q)
        wl = torch.where(qv_rep & dv.repeat(Q), wl, torch.zeros_like(wl))
        vals, rows = sharded_ivf_search(ivf, q_pair, win_start=ws, win_len=wl, **kw)
    elif req.slot_doc is not None and ivf.cluster_doc is not None:
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
    return _basic_block(vals, rows, Q, M)


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
    if isinstance(index.sparse, ShardedSparseIndex):
        # CSR shards beside the dense row shards: per-shard top-k + the
        # all-gather merge (parallel/sharded_sparse.py)
        bv_mqk, brows_mqk, ok_mqk = sharded_bm25_topk(
            index.sparse, req.q_terms, req.doc_masks, k_bm, row_slot=req.row_slot)
    else:
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


def _blank_traversal(A: int, cfg: SearchConfig, dev) -> TraversalResult:
    """What an unrouted slot's walkers return: no path."""
    H, R = cfg.max_hops, min(CAND_RECORD, cfg.neighbor_k + 1)
    return TraversalResult(
        path=torch.full((A, H + 1), -1, dtype=torch.int32, device=dev),
        valid=torch.zeros((A, H + 1), dtype=torch.bool, device=dev),
        hop_score=torch.zeros((A, H + 1), dtype=torch.float32, device=dev),
        cand_ids=torch.full((A, H, R), -1, dtype=torch.int32, device=dev),
        cand_scores=torch.zeros((A, H, R), dtype=torch.float32, device=dev))


@torch.inference_mode()
def run_traverse(index: CorpusIndex, req: Request, cfg: SearchConfig,
                 window: int, anchors_pm: torch.Tensor, mode: str,
                 n_requests: int = 1):
    """Traverse from ``[Q*M, n]`` global anchor rows (-1 = inactive).

    The ``Q*n`` walkers of a routed slot share its rows, so each slot is
    one traversal whose hops are ``dense_topk`` calls (f32 / bf16 stores):
    over the view ``emb[start : start + len]`` when the corpus is windowed,
    else over the whole store under the slot's ``[N]`` row mask.  Unrouted
    slots are skipped on the host.

    Returns ``(res, qids [A], qv [A, D])`` over ``A = M*Q*n`` walkers, in
    the JAX engine's order: (m, q, n) when the corpus is windowed and one
    window fits :data:`TRAVERSAL_WINDOW_COPY_CAP`, (q, m, n) otherwise.
    With ``n_requests = R`` stacked requests (``Q = R*Q_r``)
    the order is request-major, (r, m, q_r, n) or (r, q_r, m, n), so each
    request's walkers are one contiguous slice in single-request order."""
    q, emb, scale = req.q, index.emb, index.emb_scale
    Q, D = q.shape
    M = req.doc_masks.shape[0]
    n = anchors_pm.shape[1]
    dev = q.device
    slot_major = (window > 0 and window * D * emb.element_size()
                  <= TRAVERSAL_WINDOW_COPY_CAP)
    a_g = anchors_pm.reshape(Q, M, n).transpose(0, 1).reshape(M, Q * n)
    qv_g = q[:, None, :].expand(Q, n, D).reshape(Q * n, D)
    kw = dict(max_hops=cfg.max_hops, neighbor_k=cfg.neighbor_k, mode=mode,
              approx_rt=cfg.scan_rt)
    parts = []
    for m in range(M):
        if not req.doc_valid[m]:
            parts.append(_blank_traversal(Q * n, cfg, dev))
        elif window > 0:
            parts.append(traverse_windowed(
                emb, a_g[m : m + 1], qv_g[None], req.win_start[m : m + 1],
                req.win_len[m : m + 1], scale, window=window, **kw))
        else:
            parts.append(traverse(emb, a_g[m], qv_g, req.doc_masks[m], scale, **kw))
    R, Qr = n_requests, Q // n_requests
    # [M, R, Qr, n, ...] -> request-major, slot- or query-major inside
    order = (1, 0, 2, 3) if slot_major else (1, 2, 0, 3)

    def arrange(x):                     # x: [M, Q*n, ...]
        x = x.reshape(M, R, Qr, n, *x.shape[2:])
        return x.permute(*order, *range(4, x.dim())).reshape(M * Q * n, *x.shape[4:])

    res = TraversalResult(*(arrange(torch.stack(xs)) for xs in zip(*parts)))
    qids = arrange(torch.arange(Q, dtype=torch.int32, device=dev)
                   .repeat_interleave(n).expand(M, Q * n))
    return res, qids, arrange(qv_g.expand(M, Q * n, D))


def _arms(index: CorpusIndex, req: Request, cfg: SearchConfig, window: int,
          ivf, n_requests: int = 1, hier=None) -> Tuple[List[Block], Dict]:
    """Every arm's hit block for one request, or for ``n_requests`` stacked
    ones (each block is then request-major), and the traversal details."""
    if cfg.method not in METHODS:
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.use_ivf and ivf is None:
        raise ValueError("SearchConfig.use_ivf requires an IVFIndex "
                         "(QueryEngine.build_ivf() first)")
    if hier is not None and cfg.method != "basic":
        raise NotImplementedError(
            f"method {cfg.method!r} on a row-sharded store (hier=): the walkers "
            "hop over rows of every rank, and traversal on a row-sharded store "
            "is not ported yet (ROADMAP A.14f)")

    def basic_block(k: int) -> Block:
        # use_ivf only serves the basic block: the anchors' top-1 and the
        # hops stay exact
        if cfg.use_ivf:
            return ivf_hits(index, ivf, req, cfg, window, k)
        if hier is not None:
            return hier_dense_hits(index, req, cfg, hier, window, k)
        return dense_hits(index, req, cfg, window, k)

    def expansion(anchors_pm: torch.Tensor, mode: str):
        res, qids_t, qv_flat = run_traverse(index, req, cfg, window, anchors_pm,
                                            mode, n_requests)
        rows, sims = emit_hits(index.emb, qv_flat, res, index.emb_scale)
        mids = torch.full(rows.shape, METHOD_IDS[mode], dtype=torch.int32,
                          device=rows.device)
        return (rows, sims, qids_t[:, None].expand(rows.shape), mids,
                res.valid), res, qids_t

    blocks: List[Block] = []
    details: Dict = {}
    if cfg.method == "basic":
        blocks.append(basic_block(cfg.top_k))
    elif cfg.method in ("ssg", "triangulation"):
        # anchor = top-1 per (query, doc)
        rows, _, _, _, ok = dense_hits(index, req, cfg, window, 1)
        anchor = torch.where(ok, rows, torch.full_like(rows, -1))[:, :1]
        block, res, qids_t = expansion(anchor, cfg.method)
        blocks.append(block)
        details["trav"] = res
        details["trav_qids"] = qids_t
    else:
        rows, sims, qids, mids, ok = basic_block(HYBRID_BASIC_K)
        blocks.append((rows, sims, qids, mids, ok))
        anchors = torch.where(ok, rows, torch.full_like(rows, -1))
        ssg_block, ssg_res, _ = expansion(anchors[:, :HYBRID_SSG_ANCHORS], "ssg")
        tri_block, tri_res, _ = expansion(anchors[:, :HYBRID_TRI_ANCHORS],
                                          "triangulation")
        blocks += [ssg_block, tri_block]
        details.update(basic_rows=rows, basic_ok=ok, basic_sims=sims,
                       ssg=ssg_res, tri=tri_res)
    if cfg.use_bm25 and req.q_terms is not None and index.sparse is not None:
        blocks.append(bm25_hits(index, req, cfg, window))
    return blocks, details


def search_device(
    index: CorpusIndex, req: Request, cfg: SearchConfig, window: int = 0,
    ivf=None, hier=None,
) -> Tuple[FusedCandidates, Dict]:
    """Full fan-out + aggregation for one request on ``index``'s device:
    the method's dense and traversal arms (the basic block through the IVF
    probe with ``use_ivf``: an ``IVFIndex``, or a ``parallel.ShardedIVF``
    probed on every rank), BM25 hits (with ``use_bm25``; a
    ``ShardedSparseIndex`` merges its shards), fusion.

    ``hier = (mesh, slice_axis, dev_axis)``: ``index.emb`` (and
    ``emb_scale``) hold only this rank's rows, sharded over the flattened
    (slice, device) grid, and the dense stage of ``method="basic"`` runs
    the two-level merge (:func:`hier_dense_hits`); called on every rank,
    each returns the same result.

    Returns ``(fused_candidates, details)``.  ``details`` is empty for the
    basic method; for ``ssg`` / ``triangulation`` it holds ``trav`` (a
    :class:`TraversalResult`) and ``trav_qids``, for ``hybrid_expansion``
    ``basic_rows``, ``basic_ok``, ``basic_sims``, ``ssg`` and ``tri``:
    the JAX engine's arrays in its order (see :func:`run_traverse`)."""
    blocks, details = _arms(index, req, cfg, window, ivf, hier=hier)
    return fuse_blocks(index, blocks, cfg), details


def search_many_device(
    index: CorpusIndex, reqs: Sequence[Request], cfg: SearchConfig,
    window: int = 0, ivf=None, hier=None,
) -> List[FusedCandidates]:
    """R requests that share one route (the routing fields of ``reqs[0]``)
    in one pass.  Their padded queries are stacked ``[R*Q, D]``, so each
    routed slot of the store is read once for all of them (kernel K3 once
    ``R*Q`` exceeds K1's 64 queries) and a slot's walkers of all requests
    hop together; fusion stays per request, so the hit-count and
    method-diversity bonuses never mix across requests.  The results equal
    R :func:`search_device` calls; details are not returned."""
    R = len(reqs)
    Q = reqs[0].q.shape[0]
    terms = [r.q_terms for r in reqs]
    big = dataclasses.replace(
        reqs[0], q=torch.cat([r.q for r in reqs]),
        q_valid=torch.cat([r.q_valid for r in reqs]),
        q_terms=None if any(t is None for t in terms) else torch.cat(terms))
    blocks, _ = _arms(index, big, cfg, window, ivf, n_requests=R, hier=hier)
    out = []
    for r in range(R):
        # every block is request-major: request r is its r-th of R slices
        parts = []
        for rows, sims, qids, mids, ok in blocks:
            L = rows.shape[0] // R
            sl = slice(r * L, (r + 1) * L)
            parts.append((rows[sl], sims[sl], qids[sl] - r * Q, mids[sl], ok[sl]))
        out.append(fuse_blocks(index, parts, cfg))
    return out


class QueryEngine:
    """Host-side orchestration around :func:`search_device`.

    Owns the corpus index (on its device) and metadata, routes on host
    copies of the routing columns, and materialises candidates into the
    reference's result-dict shape.
    """

    def __init__(self, index: CorpusIndex, meta: CorpusMeta, ivf=None,
                 hier=None):
        self.index = index
        self.meta = meta
        # optional clustered index for SearchConfig(use_ivf=True): an
        # IVFIndex, or a parallel.ShardedIVF (distributed probes)
        self.ivf = ivf
        # optional (mesh, slice_axis, dev_axis): index.emb holds this rank's
        # rows and the dense stage runs the two-level merge
        self.hier = hier
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
        int8, otherwise the probe store stays f32.  A row-sharded store
        (``hier``) clusters per shard: ``parallel.build_sharded_ivf``."""
        if self.hier is not None:
            raise NotImplementedError("a row-sharded store builds its IVF per "
                                      "shard: parallel.build_sharded_ivf")
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
        (numpy or tensor).  ``with_details=True`` also returns the
        observability dict of :func:`search_device`: feed it to
        :meth:`materialize_details`."""
        req = self.prepare(query_embs, company, question, selected_years,
                           cfg, query_texts)
        cands, details = search_device(self.index, req, cfg, self.window,
                                       ivf=self.ivf if cfg.use_ivf else None,
                                       hier=self.hier)
        return (cands, details) if with_details else cands

    def search_many(
        self,
        query_embs_list: Sequence,
        company: Optional[str],
        question: str = "",
        selected_years: Optional[Sequence[int]] = None,
        cfg: SearchConfig = SearchConfig(),
        query_texts_list: Optional[Sequence[Optional[Sequence[str]]]] = None,
    ) -> List[FusedCandidates]:
        """R requests sharing one (company, years) route in one pass of
        :func:`search_many_device`; one ``FusedCandidates`` per request,
        equal to R :meth:`search` calls.  The JAX engine pads the request
        axis to a power of two to bound its jit shapes; eager PyTorch
        compiles nothing per shape, so exactly R requests are stacked."""
        doc_ids = self.routed_docs(company, question, selected_years)
        if not doc_ids:
            raise ValueError(f"No report found with '{company}' company name.")
        R = len(query_embs_list)
        if R == 0:
            return []
        dm, dv, row_slot, ws, wl, sd = self.doc_masks(doc_ids, cfg.max_docs)
        max_q = cfg.max_queries
        with_terms = cfg.use_bm25 and self.index.sparse is not None
        reqs = []
        for r in range(R):
            q, qv = self._pad_request(query_embs_list[r], max_q)
            q_terms = None
            if with_terms:
                from ..ops.bm25 import encode_queries_host

                qt = (query_texts_list[r] if query_texts_list is not None
                      and r < len(query_texts_list) else None)
                q_terms = torch.from_numpy(encode_queries_host(
                    _bm25_texts(qt, question, max_q),
                    vocab_bits=self.index.sparse.vocab_bits)).to(self.device)
            reqs.append(Request(q, qv, dm, dv, q_terms, row_slot, ws, wl, sd))
        return search_many_device(self.index, reqs, cfg, self.window,
                                  ivf=self.ivf if cfg.use_ivf else None,
                                  hier=self.hier)

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

    def materialize_details(
        self, details: Dict, cfg: SearchConfig, max_anchor_records: int = 200
    ) -> Dict:
        """The details of :func:`search_device` → the reference's payload
        shapes: ``retrieval_details`` (per-anchor traversal records with
        per-hop candidates, at most ``max_anchor_records`` of them) and, for
        hybrid expansion, ``algorithm_contribution`` (per-method new-chunk
        stats; ``new_only`` counts unique chunks)."""
        out: Dict = {"retrieval_details": None, "algorithm_contribution": None}
        if not details:
            return out

        def host(x):
            return x.cpu().numpy()

        def chunk_info(row: int) -> Dict:
            d = int(self._doc_ids_np[row])
            return {
                "chunk_id": int(row),
                "page": int(self._page_np[row]),
                "source_sha1": self.meta.docs[d].sha1,
            }

        def traversal_info(res: TraversalResult) -> List[Dict]:
            path, hop_score = host(res.path), host(res.hop_score)
            cand_ids, cand_scores = host(res.cand_ids), host(res.cand_scores)
            infos = []
            for a in range(path.shape[0]):
                if path[a, 0] < 0:
                    continue
                if len(infos) >= max_anchor_records:
                    break
                p = [int(x) for x in path[a] if x >= 0]
                hops = []
                for h in range(path.shape[1] - 1):
                    sel = int(path[a, h + 1])
                    if sel < 0:
                        break
                    cands = [
                        {
                            "idx": int(cand_ids[a, h, j]),
                            "score": float(cand_scores[a, h, j]),
                            "selected": int(cand_ids[a, h, j]) == sel,
                        }
                        for j in range(cand_ids.shape[2])
                        if cand_ids[a, h, j] >= 0
                    ]
                    hops.append({
                        "hop_number": h + 1,
                        "current_chunk": int(path[a, h]),
                        "candidates": cands,
                        "selected_idx": sel,
                        "selected_score": float(hop_score[a, h + 1]),
                    })
                infos.append({
                    "anchor": {"idx": int(path[a, 0]), "score": float(hop_score[a, 0])},
                    "hops": hops,
                    "path": p,
                    "total_hops": len(hops),
                    "total_discovered": len(p),
                })
            return infos

        if cfg.method in ("ssg", "triangulation"):
            infos = traversal_info(details["trav"])
            out["retrieval_details"] = {
                "method": cfg.method,
                "traversal_info": infos[0] if len(infos) == 1 else infos,
                "max_hops": cfg.max_hops,
                "neighbor_k": cfg.neighbor_k,
            }
        elif cfg.method == "hybrid_expansion":
            basic_rows = host(details["basic_rows"])
            basic_set = set(basic_rows[host(details["basic_ok"])].tolist())

            def method_stats(res: TraversalResult) -> Tuple[Dict, List[Dict]]:
                hops = host(res.path)[:, 1:]
                expanded = hops[hops >= 0]
                uniq = set(expanded.tolist())
                new = sorted(uniq - basic_set)
                stats = {
                    "total_expanded": int(expanded.size),
                    "new_only": len(new),
                    "in_basic_top50": len(uniq) - len(new),
                }
                return stats, [chunk_info(r) for r in new]

            ssg_stats, ssg_new = method_stats(details["ssg"])
            tri_stats, tri_new = method_stats(details["tri"])
            out["algorithm_contribution"] = {
                "basic_retrieval_count": len(basic_set),
                "ssg_new_chunks_count": len(ssg_new),
                "triangulation_new_chunks_count": len(tri_new),
                "ssg_new_chunks": ssg_new,
                "triangulation_new_chunks": tri_new,
                "ssg_stats": ssg_stats,
                "triangulation_stats": tri_stats,
            }
            # bounded per-anchor traversal records for a drill-down view
            out["retrieval_details"] = {
                "method": cfg.method,
                "traversal_info": traversal_info(details["ssg"]),
                "max_hops": cfg.max_hops,
                "neighbor_k": cfg.neighbor_k,
            }
        return out
