"""Graph-traversal retrieval: SSG, Triangulation, hybrid expansion.

Port of ``rag_challenge_2_tpu/retrieval/traversal.py``.  Every anchor (a
(query, document) pair's best chunk, or one of the basic top-k seeds)
walks its document's chunk-similarity graph in parallel, one batch row
per walker:

* a hop is "scores of the walkers' current vectors against a set of store
  rows, masked, top-(neighbor_k + 1)".  On an f32 / bf16 store with a mask
  shared by the walkers that is ``ops.topk.dense_topk``: kernel K1 up to 64
  walkers, kernel K3 above (split at 128), so no ``[A, W]`` score matrix
  is written; with ``neighbor_k + 1`` above the kernels' 64 candidates it
  routes to ``ops.topk.wide_topk``.  The JAX package computes the same hop
  as an einsum plus ``lax.top_k``;
* an int8 store scores the f32 walker vector against the dequantized rows
  (K3's int8 forms quantize the query too, which is another number), and a
  per-walker ``[A, N]`` mask is one no kernel takes: both hops are
  ``ops.topk.wide_topk``, in row blocks with a carried stable top-k
  (:func:`_plain_hop`), so neither the scores nor an f32 copy of a large
  document is ever whole in memory;
* the visited set is the path itself, checked by broadcast comparison;
* SSG stops when the chunk-to-chunk similarity does not strictly improve;
  the first hop is exempt (the bar starts at NEG_INF), as in the JAX
  package;
* Triangulation picks max ``1 / (1 + ‖(q + c + x)/3 − q‖₂)``, expanded as
  ``(‖x‖² + ‖c − 2q‖² + 2·x·c − 4·q·x) / 9``: ``x·c`` is the hop's own
  value, ``q·x`` and ``‖x‖²`` come from a gather of the k + 1 candidate
  rows, and it never stops early;
* the hop loop is a Python loop with no device synchronisation: the early
  stop is a mask, not a ``break``;
* on a row-sharded store (``shard=``, a
  ``parallel.sharded_traversal.RowShard``) each rank hops over its own
  rows and the candidates merge over the mesh, where the JAX package lets
  GSPMD partition the same program.

``approx_rt`` is accepted and every hop is exact (``ops/topk.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import device  # noqa: F401  (full-f32 matmuls for the plain hops)
from ..ops.quant import gather_rows_f32
from ..ops.topk import NEG_INF, dense_topk, fill_overflow, stable_topk, wide_topk


class TraversalResult(NamedTuple):
    """Paths of shape [A, max_hops+1]; position 0 is the anchor."""

    path: torch.Tensor         # i32 [A, H+1], -1 where traversal stopped
    valid: torch.Tensor        # bool [A, H+1]
    hop_score: torch.Tensor    # f32 [A, H+1], per-hop score (SSG: chunk-to-
                               # chunk sim; Tri: centroid score; anchor
                               # slot: 1.0 / query·anchor respectively)
    cand_ids: torch.Tensor     # i32 [A, H, R], per-hop candidate rows, -1 pad
    cand_scores: torch.Tensor  # f32 [A, H, R], matching step scores


CAND_RECORD = 10  # candidates kept per hop

# Width from which the JAX package's hops switch to ``lax.approx_max_k``
# when ``approx_rt`` is set; kept for the shared configuration surface.
HOP_APPROX_MIN_COLS = 1 << 16

# Rows per step of the plain hop (:func:`_plain_hop`): bounds the f32 copy
# of an int8 block and the ``[A, block]`` scores.
HOP_BLOCK_ROWS = 1 << 16


def _plain_hop(lhs, emb, row_scale, mask, k):
    """Top-k of ``lhs · rows`` by ``ops.topk.wide_topk`` in blocks of
    :data:`HOP_BLOCK_ROWS` rows, with the one-shot top-k's overflow slots
    (masked rows at NEG_INF, lowest first).  ``mask`` is None, ``[N]`` or
    ``[A, N]``; an int8 store (``row_scale``) is scored dequantized."""
    return fill_overflow(*wide_topk(lhs, emb, k, mask, row_scale=row_scale,
                                    block=HOP_BLOCK_ROWS), mask)


def _hop_candidates(cur_vec, emb, row_scale, mask, path, neighbor_k,
                    query_vec=None, approx_rt=None, shard=None):
    """Top-(k+1) neighbours of the current vectors among ``emb``'s rows,
    with visited flags; always k + 1 columns (a store of fewer rows pads
    with NEG_INF / row -1).

    Returns ``(vals, ids, visited, qx, xn2)``.  With ``query_vec``
    (triangulation) ``qx`` is the per-candidate ``q·x`` and ``xn2`` the
    candidate's ``‖x‖²``, both from one gather of the k + 1 candidate rows
    (the JAX package reads them from a second score matrix and a row-norm
    table); else both are None.  With ``shard`` (a
    ``parallel.sharded_traversal.RowShard``) ``emb`` is this rank's rows
    of the frame, possibly none: the rank's k + 1 candidates, with ``q·x``
    and ``‖x‖²`` of its own rows, merge over the mesh into frame rows."""
    k = neighbor_k + 1
    shared = mask is None or mask.dim() == 1
    if emb.shape[0] == 0:                  # a rank that holds none of the rows
        vals = cur_vec.new_empty((cur_vec.shape[0], 0), dtype=torch.float32)
        ids = torch.empty((cur_vec.shape[0], 0), dtype=torch.int32, device=emb.device)
    elif emb.dtype != torch.int8 and shared:
        vals, ids = dense_topk(cur_vec, emb, k, mask=mask)
    else:
        vals, ids = _plain_hop(cur_vec, emb, row_scale, mask, k)
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad), NEG_INF)], 1)
        ids = torch.cat([ids, ids.new_full((ids.shape[0], pad), -1)], 1)
    terms = ()
    if query_vec is not None and emb.shape[0]:
        # [A, k+1, D] on every rank as on one device, so a candidate's
        # terms are summed in the same order wherever it is scored
        x = gather_rows_f32(emb, row_scale, ids.clamp(min=0))
        terms = (torch.einsum("ad,akd->ak", query_vec.float(), x), (x * x).sum(dim=2))
    elif query_vec is not None:
        terms = (torch.zeros_like(vals), torch.zeros_like(vals))
    if shard is not None:
        vals, ids, *terms = shard.hop_topk(vals, ids, terms)
    visited = (path[:, :, None] == ids[:, None, :]).any(dim=1)
    qx, xn2 = terms if terms else (None, None)
    return vals, ids, visited, qx, xn2


@torch.inference_mode()
def traverse(
    emb: torch.Tensor,
    anchor_idx: torch.Tensor,
    query_vec: torch.Tensor,
    mask: Optional[torch.Tensor],
    row_scale: Optional[torch.Tensor] = None,
    *,
    max_hops: int = 4,
    neighbor_k: int = 30,
    mode: str = "ssg",
    approx_rt: Optional[float] = None,
    shard=None,
) -> TraversalResult:
    """Run SSG or Triangulation traversal for a batch of anchors.

    Args:
        emb: ``[N, D]`` store rows (f32, bf16, or int8 with ``row_scale``).
        anchor_idx: ``[A]`` starting rows (-1, or a row outside the store,
            = inactive anchor).
        query_vec: ``[A, D]`` query embedding per anchor (SSG ignores it for
            stepping; Triangulation uses it for the centroid).
        mask: ``[N]`` bool rows the anchors may visit, shared by all of
            them (or None: every row), or ``[A, N]`` per anchor.  Kernels
            K1 and K3 take no per-query mask, so with an ``[A, N]`` mask
            the hops are computed in plain PyTorch on the card as well;
            the engine groups its walkers by document slot and passes the
            slot's ``[N]`` mask instead.  With ``shard`` the mask covers
            this rank's rows: ``[n_local]`` or ``[A, n_local]``.
        mode: "ssg" | "triangulation".
        shard: a ``parallel.sharded_traversal.RowShard``: ``emb`` (and
            ``row_scale``, ``mask``) hold only this rank's rows of a
            row-sharded frame of ``shard.n_rows`` rows (possibly none);
            anchors, paths and candidates are frame rows.  Every rank of
            the mesh calls this in the same order and gets the same
            result, the single-device traversal of the whole frame.
    """
    if mode not in ("ssg", "triangulation"):
        raise ValueError(f"mode must be 'ssg' or 'triangulation', got {mode!r}")
    A, H = anchor_idx.shape[0], max_hops
    N = emb.shape[0] if shard is None else shard.n_rows
    dev = emb.device
    k1 = neighbor_k + 1
    R = min(CAND_RECORD, k1)
    anchor_idx = anchor_idx.to(torch.int32)
    active = (anchor_idx >= 0) & (anchor_idx < N)
    anchor_idx = torch.where(active, anchor_idx, torch.full_like(anchor_idx, -1))
    path = torch.full((A, H + 1), -1, dtype=torch.int32, device=dev)
    path[:, 0] = anchor_idx
    hop_score = torch.zeros((A, H + 1), dtype=torch.float32, device=dev)
    cand_ids = torch.full((A, H, R), -1, dtype=torch.int32, device=dev)
    cand_scores = torch.zeros((A, H, R), dtype=torch.float32, device=dev)
    if N == 0 or A == 0:          # the same on every rank of a sharded frame
        return TraversalResult(path, path >= 0, hop_score, cand_ids, cand_scores)
    if mask is not None:
        mask = mask.bool().contiguous()

    def read(idx):                # f32 rows of the frame, on every rank
        if shard is None:
            return gather_rows_f32(emb, row_scale, idx)
        return shard.gather_rows(emb, row_scale, idx)

    q_f = query_vec.float()
    cur_idx = anchor_idx.clamp(min=0)
    cur_vec = read(cur_idx)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    if mode == "ssg":
        hop_score[:, 0] = active.float()
    else:
        hop_score[:, 0] = torch.where(active, (q_f * cur_vec).sum(1), zero)
        q_n2 = (q_f * q_f).sum(1)
    # the first hop is exempt from SSG's early stop (see the module docstring)
    prev_sim = torch.full((A,), NEG_INF, dtype=torch.float32, device=dev)

    for hop in range(H):
        vals, ids, visited, qx, xn2 = _hop_candidates(
            cur_vec.contiguous(), emb, row_scale, mask, path, neighbor_k,
            query_vec=None if mode == "ssg" else q_f, approx_rt=approx_rt,
            shard=shard)
        cand_ok = ~visited & (vals > NEG_INF / 2)
        if mode == "ssg":
            # step score = chunk-to-chunk similarity = the hop's own score
            step_score = vals
        else:
            c_n2 = (cur_vec * cur_vec).sum(1)
            c_q = (cur_vec * q_f).sum(1)
            const = c_n2 - 4.0 * c_q + 4.0 * q_n2                    # ‖c−2q‖²
            dist2 = (xn2 + const[:, None] + 2.0 * vals - 4.0 * qx) / 9.0
            step_score = 1.0 / (1.0 + dist2.clamp(min=0.0).sqrt())
        step_score = torch.where(cand_ok, step_score, neg)
        best_j = step_score.argmax(dim=1, keepdim=True)   # first maximum
        best_score = step_score.gather(1, best_j)[:, 0]
        best_id = ids.gather(1, best_j)[:, 0]
        step = active & cand_ok.any(dim=1)
        if mode == "ssg":
            # early stop: the similarity must strictly improve
            step = step & (best_score > prev_sim)

        cur_idx = torch.where(step, best_id, cur_idx)
        path[:, hop + 1] = torch.where(step, best_id, torch.full_like(best_id, -1))
        hop_score[:, hop + 1] = torch.where(step, best_score, zero)

        # the hop's top-R candidates, for the traversal details
        r_vals, r_j = stable_topk(step_score, R)
        r_ids = ids.gather(1, r_j)
        rec_ok = step[:, None] & (r_vals > NEG_INF / 2)
        cand_ids[:, hop] = torch.where(rec_ok, r_ids, torch.full_like(r_ids, -1))
        cand_scores[:, hop] = torch.where(rec_ok, r_vals, zero)

        cur_vec = torch.where(step[:, None], read(cur_idx), cur_vec)
        prev_sim = torch.where(step, best_score, prev_sim)
        active = step
    return TraversalResult(path, path >= 0, hop_score, cand_ids, cand_scores)


def _to_global(res: TraversalResult, start: int) -> TraversalResult:
    path = torch.where(res.path >= 0, res.path + start, res.path)
    cand = torch.where(res.cand_ids >= 0, res.cand_ids + start, res.cand_ids)
    return res._replace(path=path, cand_ids=cand)


@torch.inference_mode()
def traverse_windowed(
    emb: torch.Tensor,
    anchor_idx: torch.Tensor,
    query_vec: torch.Tensor,
    win_start,
    win_len,
    row_scale: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
    max_hops: int = 4,
    neighbor_k: int = 30,
    mode: str = "ssg",
    approx_rt: Optional[float] = None,
    shard=None,
) -> TraversalResult:
    """:func:`traverse` restricted to per-group document row ranges.

    A traversal only ever visits rows of its anchor's document, and
    documents are contiguous row ranges, so each group g walks the view
    ``emb[win_start[g] : win_start[g] + win_len[g]]`` (no copy, no mask)
    and its hops read that document alone.

    Args:
        emb: ``[N, D]`` store rows.
        anchor_idx: ``[G, A]`` GLOBAL anchor rows, -1 = inactive; an anchor
            outside its group's row range is inactive too.
        query_vec: ``[G, A, D]`` query embedding per anchor.
        win_start: ``[G]`` first row of each group's document (a host
            sequence, or a tensor that is read once before the hops).
        win_len: ``[G]`` number of document rows; 0 skips the group.
        window: the JAX package's padded window size; accepted, and unused
            since a view needs no padding.
        shard: a ``parallel.sharded_traversal.RowShard``: ``emb`` (and
            ``row_scale``) hold this rank's rows of the row-sharded store,
            and each group walks this rank's part of its range (a document
            may span ranks; a rank that holds none of it still takes part
            in every hop's collectives).

    Returns a TraversalResult over ``G*A`` anchors with GLOBAL row ids,
    identical (paths, scores, candidate records) to :func:`traverse` with
    the equivalent ``[G*A, N]`` document masks.
    """
    del window
    starts = win_start.tolist() if hasattr(win_start, "tolist") else list(win_start)
    lens = win_len.tolist() if hasattr(win_len, "tolist") else list(win_len)
    parts = []
    for g, (ws, wl) in enumerate(zip(starts, lens)):
        ws, wl = int(ws), int(wl)
        a = anchor_idx[g]
        local = torch.where(a >= 0, a - ws, torch.full_like(a, -1))
        lo, hi, part = ws, ws + wl, None
        if shard is not None:       # this rank's rows of the document
            lo, hi, part = shard.window(ws, wl, emb.shape[0])
        res = traverse(
            emb[lo:hi], local, query_vec[g], None,
            None if row_scale is None else row_scale[lo:hi],
            max_hops=max_hops, neighbor_k=neighbor_k, mode=mode,
            approx_rt=approx_rt, shard=part)
        parts.append(_to_global(res, ws))
    return TraversalResult(*(torch.cat(xs) for xs in zip(*parts)))


@torch.inference_mode()
def emit_hits(
    emb: torch.Tensor,
    query_vec: torch.Tensor,
    res: TraversalResult,
    row_scale: Optional[torch.Tensor] = None,
    shard=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-score traversal paths as query·chunk similarities: every path
    element (anchor included) becomes a hit with similarity
    ``inner(query, chunk)``.  With ``shard`` (a
    ``parallel.sharded_traversal.RowShard`` over the store's frame) the
    owner of each path row scores it and the similarities are summed over
    the mesh, so every rank returns the single-device hits.

    Returns (rows [A, H+1] i32 with -1 for invalid, sims [A, H+1] f32).
    """
    rows = res.path
    if shard is None:
        vecs = gather_rows_f32(emb, row_scale, rows.clamp(min=0))  # [A, H+1, D]
    else:
        vecs = shard.local_rows(emb, row_scale, rows)
    sims = torch.einsum("ad,ahd->ah", query_vec.float(), vecs)
    if shard is not None:
        sims = shard.sum(sims)
    return rows, torch.where(res.valid, sims, torch.zeros_like(sims))
