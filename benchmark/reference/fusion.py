"""Max fusion of a request's hits with the query-hit and method bonuses.

A key (here a store row) hit by the request's arms scores

    max(sims of its hits) * (1 + 0.2 * (distinct queries - 1))
                          * (1 + 0.1 * (distinct methods - 1))

and the request returns its ``top_n`` keys by that score.  A hit is one
(row, query, method, sim); the dense arm is method 0 and BM25 method 3.
Where an arm's k-th best has rivals within the tie tolerance, either may
be a hit, so each key gets the score of its sure hits (``lo``) and of its
sure and possible hits together (``hi``); a program's score for the key is
right anywhere between the two.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

QUERY_BONUS = 0.2
METHOD_BONUS = 0.1


def _fused(key, qid, mid, sim) -> Tuple[np.ndarray, np.ndarray]:
    """``(keys, score)`` over the hits given, in f64."""
    if key.size == 0:
        return np.zeros(0, np.int64), np.zeros(0)
    keys, inv = np.unique(key, return_inverse=True)
    best = np.full(keys.size, -np.inf)
    np.maximum.at(best, inv, sim)

    def distinct(other):
        pairs = np.unique(inv.astype(np.int64) * (1 << 20) + other)
        return np.bincount(pairs >> 20, minlength=keys.size)

    nq, nm = distinct(qid), distinct(mid)
    return keys, best * (1 + QUERY_BONUS * (nq - 1)) * (1 + METHOD_BONUS * (nm - 1))


def fuse_bounds(hits: Sequence[tuple]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``hits``: ``(rows, sims, sure, qid, method)`` arrays, one tuple an
    arm and (query, document).  Returns ``(keys, lo, hi)``, ``lo`` NaN for
    a key with no sure hit."""
    if not hits:
        return np.zeros(0, np.int64), np.zeros(0), np.zeros(0)
    key = np.concatenate([h[0] for h in hits]).astype(np.int64)
    sim = np.concatenate([h[1] for h in hits]).astype(np.float64)
    sure = np.concatenate([h[2] for h in hits]).astype(bool)
    qid = np.concatenate([np.full(len(h[0]), h[3], np.int64) for h in hits])
    mid = np.concatenate([np.full(len(h[0]), h[4], np.int64) for h in hits])
    keys, hi = _fused(key, qid, mid, sim)
    k_lo, s_lo = _fused(key[sure], qid[sure], mid[sure], sim[sure])
    lo = np.full(keys.size, np.nan)
    lo[np.searchsorted(keys, k_lo)] = s_lo
    return keys, lo, hi


def top_keys(keys: np.ndarray, score: np.ndarray, n: int) -> np.ndarray:
    """The ``n`` best keys by score, ties to the smaller key."""
    order = np.lexsort((keys, -score))
    return keys[order[:n]]
