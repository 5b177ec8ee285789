"""The inputs of a cell, made from ``--seed``: store rows, documents and
the BM25 CSR of a configuration file.

Rows are made in chunks on the device, each chunk from a generator of its
own seeded from the run's seed and the chunk's number, so any chunk can be
made again alike (the reference does so after the window).  A row is a
unit centre plus ``row_noise / sqrt(D)`` Gaussian noise, normalised
(``centres: 0``: a plain Gaussian row, normalised).  The documents are
contiguous row ranges, one a year, of one company; the CSR has ``2**vocab_bits``
terms of 1 to ``max_postings`` postings each (uniform), postings in
uniform rows with term frequency 1 to ``tf_max`` and row lengths uniform in
``chunk_len``.  These follow ``bench.py`` (``bench_int8_10m``,
``bench_hybrid_at_scale``), the reference's benchmark.  Rows planted by
set-up (``Store.planted``: sorted row numbers and their f32 rows) replace
the drawn rows there, in every chunk made, the reference's too.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed drawn from the run's seed and ``keys`` (ints or
    strings): the same arguments give the same seed in any process."""
    words = [int(seed) & ((1 << 64) - 1)]
    words += [zlib.crc32(k.encode()) if isinstance(k, str) else int(k) for k in keys]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def generator(dev, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(sub_seed(seed, *keys))


def host_rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *keys))


@dataclass
class Store:
    """One configuration's inputs for one seed on one device."""
    cfg: dict
    seed: int
    dev: torch.device
    planted: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def n_rows(self) -> int:
        return int(self.cfg["rows"])

    @property
    def dim(self) -> int:
        return int(self.cfg["dim"])

    def chunks(self) -> List[Tuple[int, int]]:
        c = int(self.cfg["chunk_rows"])
        return [(s, min(s + c, self.n_rows)) for s in range(0, self.n_rows, c)]

    def docs(self) -> List[dict]:
        """Contiguous documents, one a year; the last takes the remainder."""
        years = list(self.cfg["years"])
        per = self.n_rows // len(years)
        out = []
        for d, year in enumerate(years):
            stop = self.n_rows if d == len(years) - 1 else (d + 1) * per
            out.append(dict(company=self.cfg["company"], year=int(year),
                            start=d * per, stop=stop, sha1=f"doc{d}_{year}"))
        return out

    def centres(self) -> torch.Tensor:
        n = int(self.cfg["centres"])
        if n == 0:
            return torch.zeros((0, self.dim), device=self.dev)
        c = torch.randn(n, self.dim, generator=generator(self.dev, self.seed, "centres"),
                        device=self.dev)
        return c / c.norm(dim=1, keepdim=True)

    def chunk(self, i: int, centres: torch.Tensor) -> torch.Tensor:
        """Rows ``chunks()[i]`` in f32, ``[n, D]``."""
        s, e = self.chunks()[i]
        n, D = e - s, self.dim
        g = generator(self.dev, self.seed, "rows", i)
        if centres.shape[0]:
            a = torch.randint(0, centres.shape[0], (n,), generator=g, device=self.dev)
            x = centres[a] + (float(self.cfg["row_noise"]) / D ** 0.5) * torch.randn(
                n, D, generator=g, device=self.dev)
        else:
            x = torch.randn(n, D, generator=g, device=self.dev)
        x = x / x.norm(dim=1, keepdim=True)
        if self.planted is not None:
            rows, vecs = self.planted
            lo, hi = torch.searchsorted(rows, torch.tensor([s, e], device=rows.device)).tolist()
            x[rows[lo:hi] - s] = vecs[lo:hi]
        return x

    def each_chunk(self) -> Iterator[Tuple[int, int, torch.Tensor]]:
        centres = self.centres()
        for i, (s, e) in enumerate(self.chunks()):
            yield s, e, self.chunk(i, centres)

    def csr(self) -> Dict[str, object]:
        """The BM25 CSR on the device: ``indptr`` (i32 ``[V + 1]``),
        ``chunk_ids`` (i32), ``tf`` and ``dl`` (f32) over ``nnz`` postings
        plus ``pad`` slack postings, ``df`` (f32 ``[V]``), ``chunk_len``
        (f32 ``[N]``) and ``avgdl`` (their f32 mean, 0-d)."""
        c = self.cfg["csr"]
        V, W = 1 << int(c["vocab_bits"]), int(c["max_postings"])
        g = generator(self.dev, self.seed, "csr")
        counts = torch.randint(1, W + 1, (V,), generator=g, device=self.dev)
        indptr = torch.zeros(V + 1, dtype=torch.int64, device=self.dev)
        indptr[1:] = torch.cumsum(counts, 0)
        nnz = int(indptr[-1])
        pad = int(c["slack"])
        total = -(-(nnz + pad) // 1024) * 1024
        chunk_ids = torch.randint(0, self.n_rows, (total,), generator=g, device=self.dev,
                                  dtype=torch.int32)
        tf = torch.randint(1, int(c["tf_max"]) + 1, (total,), generator=g,
                           device=self.dev).float()
        lo, hi = c["chunk_len"]
        chunk_len = torch.randint(int(lo), int(hi), (self.n_rows,), generator=g,
                                  device=self.dev).float()
        return dict(V=V, W=W, vocab_bits=int(c["vocab_bits"]),
                    indptr=indptr.to(torch.int32), chunk_ids=chunk_ids, tf=tf,
                    dl=chunk_len[chunk_ids.long()], df=counts.float(),
                    chunk_len=chunk_len, avgdl=chunk_len.mean(), nnz=nnz,
                    pad=total - nnz)
