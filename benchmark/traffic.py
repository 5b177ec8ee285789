"""The one generator of requests: a traffic mix file (``traffic/<mix>.json``)
and the run's seed give a fixed pool of requests, the same on every run
of a seed, and the order each client sends them in.

Two loops read a mix:

* ``scan``: one client in a closed loop; each request is one call of the
  dense layer's public entry on the whole store with ``batch`` query
  vectors, drawn in turn from ``pool_batches`` batches.  A query is a
  store row drawn uniformly from all rows, plus ``query_noise / sqrt(D)``
  Gaussian noise, normalised.
* ``clients``: ``clients`` threads in a closed loop; each request is one
  question through the engine (``entry: engine``) or the micro-batcher
  (``entry: batcher``).  A question names a year from ``years``
  (``year_counts`` of each in the pool, in a seeded order; a year of
  ``null`` names none) and is routed to the documents within
  ``year_window`` years of it.  It carries ``queries_per_request`` query
  vectors, each a row of one of its routed documents plus noise, and as
  many texts from ``templates`` with the metric names drawn without
  repeats.
* ``encode``: one client in a closed loop; each request is one batch of
  ``batch`` texts as token ids, drawn in turn from ``pool_batches``
  batches, sent through the encoder's public entry (and, with ``then``,
  its embeddings on to the dense layer's entry).  A text's length comes
  from ``lengths``, a distribution or lengths measured on real texts:
  the pool takes its quantiles at the midpoints of ``batch *
  pool_batches`` equal steps, so every seed has the same lengths, dealt
  out in a seeded order; its ids are uniform over the model's
  vocabulary.  A batch is padded with -1 to the power of two
  at or above its longest text, at least 32 and at most the model's
  longest sequence.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .stores import Store, generator, host_rng


@dataclass
class Question:
    year: Optional[int]
    years: Optional[List[int]]       # the years routed to (None: all)
    docs: List[int]                  # the routed documents
    rows: np.ndarray                 # the source rows of its query vectors
    texts: List[str]
    vectors: Optional[np.ndarray] = None   # [Q, D] f32, after make_vectors


def routed(docs: List[dict], years: Optional[List[int]]) -> List[int]:
    """The documents a question with ``years`` reaches, for drawing its
    source rows (the benchmark's own view of the routing rule)."""
    if not years:
        return list(range(len(docs)))
    own = [i for i, d in enumerate(docs) if d["year"] in years]
    return own or list(range(len(docs)))


def scan_rows(mix: dict, store: Store, seed: int) -> np.ndarray:
    """Source rows of the scan pool, ``[pool_batches * batch]``."""
    n = int(mix["pool_batches"]) * int(mix["batch"])
    return np.sort(host_rng(seed, "scan_rows").integers(0, store.n_rows, n))


def questions(mix: dict, store: Store, seed: int) -> List[Question]:
    rng = host_rng(seed, "questions")
    docs = store.docs()
    years = []
    for y, n in zip(mix["years"], mix["year_counts"]):
        years += [y] * int(n)
    years = [years[i] for i in rng.permutation(len(years))]
    Q, w = int(mix["queries_per_request"]), int(mix["year_window"])
    out = []
    for y in years:
        ys = None if y is None else list(range(int(y) - w, int(y) + w + 1))
        ds = routed(docs, ys)
        spans = [(docs[d]["start"], docs[d]["stop"]) for d in ds]
        sizes = np.array([e - s for s, e in spans])
        which = rng.choice(len(spans), size=Q, p=sizes / sizes.sum())
        rows = np.array([spans[m][0] + rng.integers(0, sizes[m]) for m in which])
        names = rng.permutation(len(mix["metrics"]))[:Q]
        tmpl = mix["templates"]
        texts = [tmpl[int(rng.integers(len(tmpl)))].format(
            year="" if y is None else y, company=store.cfg["company"],
            metric=mix["metrics"][int(i)]) for i in names]
        out.append(Question(y, ys, ds, rows, texts))
    return out


def make_vectors(src: torch.Tensor, mix: dict, store: Store, seed: int) -> torch.Tensor:
    """Query vectors from their f32 source rows ``src [n, D]``."""
    g = generator(store.dev, seed, "query_noise")
    noise = torch.randn(src.shape, generator=g, device=store.dev)
    q = src + (float(mix["query_noise"]) / store.dim ** 0.5) * noise
    return q / q.norm(dim=1, keepdim=True)


def client_orders(mix: dict, n_pool: int, seed: int) -> List[np.ndarray]:
    """For each client, the order it sends the pool's requests in (it
    cycles through its order)."""
    rng = host_rng(seed, "clients")
    return [rng.permutation(n_pool) for _ in range(int(mix["clients"]))]


def text_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths: the quantiles at ``(j + 0.5) / n`` of ``spec``'s
    distribution, ascending.  ``measured``: the lengths ``values`` (each
    an equal share); ``uniform``: whole numbers ``lo`` to ``hi``;
    ``lognormal``: ``median * exp(sigma * z)`` rounded and clipped to
    ``[lo, hi]``."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "measured":
        v = np.sort(np.asarray(spec["values"], np.int64))
        return v[np.floor(u * v.size).astype(np.int64)]
    lo, hi = int(spec["lo"]), int(spec["hi"])
    if spec["dist"] == "uniform":
        return lo + np.floor(u * (hi - lo + 1)).astype(np.int64)
    if spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        x = np.rint(float(spec["median"]) * np.exp(float(spec["sigma"]) * z))
        return np.clip(x, lo, hi).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def bucket(longest: int, max_len: int) -> int:
    """The padded width of a batch whose longest text is ``longest``."""
    return min(max(32, 1 << math.ceil(math.log2(max(longest, 1)))), max_len)


def token_batches(mix: dict, seed: int, vocab: int, max_len: int) -> List[torch.Tensor]:
    """The ``encode`` pool: ``pool_batches`` host i32 ``[batch, L]`` id
    batches padded with -1."""
    B, n = int(mix["batch"]), int(mix["pool_batches"])
    lens = np.minimum(text_lengths(mix["lengths"], B * n), max_len)
    lens = lens[host_rng(seed, "lengths").permutation(lens.size)].reshape(n, B)
    rng = host_rng(seed, "token_ids")
    out = []
    for row_lens in lens:
        L = bucket(int(row_lens.max()), max_len)
        ids = rng.integers(0, vocab, (B, L), dtype=np.int32)
        ids[np.arange(L)[None, :] >= row_lens[:, None]] = -1
        out.append(torch.from_numpy(ids))
    return out
