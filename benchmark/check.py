"""What decides ``correct``: the program's answers from the window held
against the plain reference (``reference/``), and the f32 answers that
``recall_at_10`` is measured against.

The reference runs after the window, once the program's state is freed:
it makes the store's rows again from the seed, chunk by chunk, scores
every pool query in the configuration's form, and keeps each query's best
rows.  Every distinct answer the program gave in the window is compared:

* scan cells, per query: ``value_gap``, the widest gap between a value the
  program returned and the reference's score of that row; ``cut_gap``, the
  most by which a row of the reference's top k that the program left out
  beats the worst row it kept (0 under ties); ``wrong``, the rows that
  are invalid, repeated or missing;
* served cells, per request: routing, both arms and fusion in the
  reference give each key a fused score between ``lo`` (its sure hits)
  and ``hi`` (with the hits an arm's tie may add or drop); ``fused_gap``
  is the larger of the most by which a returned score lies outside that
  range (a key no arm reaches: its whole score) and the most by which a
  key left out certainly beats the worst key kept; ``wrong`` counts the
  keys repeated and a list of the wrong length;
* encode cells, per answer: ``embed_gap``, the largest L2 distance between
  an embedding the program returned and the reference model's
  (``reference/models/<model.reference>.py``, f32, the same ids and
  weights); ``norm_gap``, the most by which an embedding's norm differs
  from 1 (both are unit vectors); ``wrong``, the rows missing or not
  finite.  With ``then`` the scan's numbers follow, the program's own
  embeddings as the queries, and ``recall_at_10`` is measured against the
  reference pipeline: the reference's embeddings scanned in f32.
"""

from __future__ import annotations

import importlib.util
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .reference import bm25 as rbm25
from .reference import fusion, routing, scoring
from .reference.tokenize import term_ids
from .stores import Store
from .traffic import Question

HERE = Path(__file__).resolve().parent
KEEP = 96            # candidates kept a query (above k: rows tied at the cut)
QUERY_BLOCK = 1024   # queries scored against a chunk at once


def ref_csr(store: Store) -> rbm25.Csr:
    c = store.csr()
    return rbm25.Csr(indptr=c["indptr"].long().cpu().numpy(), chunk_ids=c["chunk_ids"],
                     tf=c["tf"], df=c["df"], chunk_len=c["chunk_len"], avgdl=c["avgdl"])


# ---------------------------------------------------------------- scan

def scan_reference(store: Store, q: torch.Tensor, mode: str,
                   asked: np.ndarray, recall_k: int = 10,
                   recall_q: Optional[torch.Tensor] = None):
    """For pool queries ``q [P, D]``: each query's ``KEEP`` best rows in
    ``mode`` (f64 values), the reference's score of each row in ``asked
    [P, A]`` (-1: none), and the ``recall_k`` best rows in f32 of each of
    ``recall_q`` (default ``q``)."""
    P = q.shape[0]
    dev = q.device
    rq = q if recall_q is None else recall_q
    exact = scoring.TopPool(P, KEEP, dev)
    f32 = scoring.TopPool(rq.shape[0], recall_k, dev)
    asked_t = torch.as_tensor(asked, device=dev)
    at = torch.full(asked.shape, float("nan"), dtype=torch.float64, device=dev)
    for s, e, x in store.each_chunk():
        for b in range(0, P, QUERY_BLOCK):
            blk = slice(b, b + QUERY_BLOCK)
            sc = scoring.scores(q[blk], x, mode)
            exact.add(sc, s, blk)
            ab = asked_t[blk]
            inside = (ab >= s) & (ab < e)
            got = torch.gather(sc.double(), 1, (ab - s).clamp(0, e - s - 1))
            at[blk] = torch.where(inside, got, at[blk])
            del sc
        for b in range(0, rq.shape[0], QUERY_BLOCK):
            blk = slice(b, b + QUERY_BLOCK)
            f32.add(scoring.scores(rq[blk], x, "f32"), s, blk)
    return (exact.vals.cpu().numpy(), exact.rows.cpu().numpy(),
            f32.rows.cpu().numpy(), at.cpu().numpy())


def compare_scan(rows: np.ndarray, vals: np.ndarray, ref_at: np.ndarray,
                 pool_vals: np.ndarray, pool_rows: np.ndarray, k: int,
                 n_rows: int) -> Dict[str, float]:
    """One answer of ``B`` queries: ``rows``/``vals`` ``[B, k]`` as the
    program returned them, ``ref_at`` the reference's score of each."""
    wrong, value_gap, cut_gap = 0, 0.0, 0.0
    k_eff = min(k, n_rows)
    for b in range(rows.shape[0]):
        r = rows[b]
        ok = (r >= 0) & (r < n_rows)
        uniq = np.unique(r[ok])
        wrong += int((~ok).sum()) + int(ok.sum() - uniq.size) + max(0, k_eff - r.size)
        if not ok.any():
            continue
        s = ref_at[b][ok]
        value_gap = max(value_gap, float(np.nanmax(np.abs(vals[b][ok] - s))))
        worst = float(np.nanmin(s))
        top = pool_rows[b][:k_eff]
        left = ~np.isin(top, uniq)
        if left.any():
            cut_gap = max(cut_gap, float(pool_vals[b][:k_eff][left].max()) - worst)
    return dict(value_gap=value_gap, cut_gap=max(cut_gap, 0.0), wrong=wrong)


def recall(got: np.ndarray, truth: np.ndarray, k: int = 10) -> float:
    """Mean share of each row of ``truth [B, >=k]``'s first k in ``got``'s first k."""
    hit = [np.isin(truth[b, :k], got[b, :k]).sum() for b in range(truth.shape[0])]
    return float(np.sum(hit)) / (k * truth.shape[0])


# -------------------------------------------------------------- encode

def model_reference(model: dict):
    """The configuration's reference model: ``reference/models/<name>.py``
    for ``model["reference"]``, with ``init``, ``forward``, ``flops``,
    ``bytes``, ``token_space`` and ``compute_type``."""
    name = model["reference"]
    path = HERE / "reference" / "models" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_model_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare_embeddings(got: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """One answer's embeddings ``got [B', D]`` against the reference's
    ``ref [B, D]``, row by row."""
    n = min(got.shape[0], ref.shape[0])
    g, r = got[:n].astype(np.float64), ref[:n].astype(np.float64)
    ok = np.isfinite(g).all(axis=1) if got.shape[1:] == ref.shape[1:] else np.zeros(n, bool)
    wrong = abs(got.shape[0] - ref.shape[0]) + int((~ok).sum())
    if not ok.any():
        return dict(embed_gap=0.0, norm_gap=0.0, wrong=wrong)
    gap = np.linalg.norm(g[ok] - r[ok], axis=1)
    norm = np.abs(np.linalg.norm(g[ok], axis=1) - 1.0)
    return dict(embed_gap=float(gap.max()), norm_gap=float(norm.max()), wrong=wrong)


# -------------------------------------------------------------- served

def served_reference(store: Store, pool: Sequence[Question], mix: dict, mode: str,
                     ties: Dict[str, float]):
    """For every question of the pool: ``(keys, lo, hi)`` of the fused
    answer in ``mode`` with its tie ranges, and the f32 answer's keys in
    order (for recall).  Dense scoring is on the store's device."""
    cfg = mix["search"]
    k, k_bm, top_n = cfg["top_k"], cfg["bm25_top_k"], cfg["top_n"]
    max_q, max_docs = cfg.get("max_queries", 8), cfg.get("max_docs", 8)
    docs = store.docs()
    dev = store.dev
    # routing, then the dense arm: each document's queries scored over its rows
    routes = [routing.routed_docs(docs, store.cfg["company"], qn.years, max_docs)
              for qn in pool]
    per_doc: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for r, qn in enumerate(pool):
        for d in routes[r]:
            for j in range(min(max_q, len(qn.vectors))):
                per_doc[d].append((r, j))
    dense_exact, dense_f32 = {}, {}
    centres = store.centres()
    chunks = store.chunks()
    for d, pairs in per_doc.items():
        ds, de = docs[d]["start"], docs[d]["stop"]
        qv = torch.as_tensor(np.stack([pool[r].vectors[j] for r, j in pairs]), device=dev)
        exact = scoring.TopPool(len(pairs), KEEP, dev)
        f32 = scoring.TopPool(len(pairs), k, dev)
        for i, (s, e) in enumerate(chunks):
            lo, hi = max(s, ds), min(e, de)
            if hi <= lo:
                continue
            x = store.chunk(i, centres)[lo - s:hi - s]
            for b in range(0, len(pairs), QUERY_BLOCK):
                blk = slice(b, b + QUERY_BLOCK)
                exact.add(scoring.scores(qv[blk], x, mode), lo, blk)
                f32.add(scoring.scores(qv[blk], x, "f32"), lo, blk)
            del x
        ev, er = exact.vals.cpu().numpy(), exact.rows.cpu().numpy()
        fv, fr = f32.vals.cpu().numpy(), f32.rows.cpu().numpy()
        for n, (r, j) in enumerate(pairs):
            dense_exact[r, j, d] = (er[n][er[n] >= 0], ev[n][er[n] >= 0])
            dense_f32[r, j, d] = (fr[n][fr[n] >= 0], fv[n][fr[n] >= 0])
    csr = ref_csr(store)
    out = []
    for r, qn in enumerate(pool):
        ranges = [(docs[d]["start"], docs[d]["stop"]) for d in routes[r]]
        texts = (list(qn.texts) + [""] * max_q)[:max_q]
        terms = term_ids(texts, store.cfg["csr"]["vocab_bits"])
        hits, hits_f32 = [], []
        for j in range(min(max_q, len(qn.vectors))):
            for d in routes[r]:
                rows, vals = dense_exact[r, j, d]
                idx, sure = rbm25.top_hits(rows, vals, k, ties["dense"])
                hits.append((rows[idx], vals[idx], sure, j, 0))
                rows, vals = dense_f32[r, j, d]
                hits_f32.append((rows, vals, np.ones(rows.size, bool), j, 0))
            if cfg.get("use_bm25"):
                for m, h in rbm25.bm25_hits(csr, terms[j], ranges, k_bm, ties["bm25"]).items():
                    hits.append((h.rows, h.sims, h.sure, j, 3))
                    hits_f32.append((h.rows, h.sims, h.sure, j, 3))
        keys, lo, hi = fusion.fuse_bounds(hits)
        fk, _, fhi = fusion.fuse_bounds(hits_f32)
        out.append((keys, lo, hi, fusion.top_keys(fk, fhi, top_n)))
    return out


def compare_served(keys: np.ndarray, scores: np.ndarray, ref, top_n: int) -> Dict[str, float]:
    """One request's answer (``keys``/``scores`` as returned, -1 = empty)
    against the reference's ``(keys, lo, hi, _)``: ``fused_gap`` is the
    larger of the most by which a returned score lies outside its key's
    range (a key no arm reaches: its whole score) and the most by which a
    key left out certainly beats the worst key kept."""
    r_keys, lo, hi, _ = ref
    live = keys >= 0
    k, s = keys[live], scores[live].astype(np.float64)
    wrong = int(k.size - np.unique(k).size)
    n_sure = int(np.sum(~np.isnan(lo)))
    if not (min(top_n, n_sure) <= k.size <= min(top_n, r_keys.size)):
        wrong += 1
    if r_keys.size == 0:
        return dict(fused_gap=float(np.max(np.abs(s), initial=0.0)), wrong=wrong)
    pos = np.minimum(np.searchsorted(r_keys, k), r_keys.size - 1)
    known = r_keys[pos] == k
    lo_k = np.where(known, np.nan_to_num(lo[pos], nan=0.0), 0.0)
    hi_k = np.where(known, hi[pos], 0.0)
    gap = float(np.max(np.maximum(np.maximum(lo_k - s, s - hi_k), 0.0), initial=0.0))
    if k.size:
        out = ~np.isin(r_keys, k) & ~np.isnan(lo)
        if out.any():
            gap = max(gap, float(lo[out].max()) - float(hi_k.min()))
    return dict(fused_gap=gap, wrong=wrong)


def worst(readings: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each number over ``readings`` (``wrong`` summed)."""
    out: Dict[str, float] = {}
    for r in readings:
        for name, v in r.items():
            out[name] = out.get(name, 0) + v if name == "wrong" else max(out.get(name, 0.0), v)
    return out
