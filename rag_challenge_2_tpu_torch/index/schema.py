"""Index format: the corpus as dataclasses of tensors.

Port of ``rag_challenge_2_tpu/index/schema.py``.  ONE corpus-wide
embedding matrix on the device, padded to ``ROW_PAD`` rows; per-document
routing becomes masks over rows; row-aligned metadata columns are int32
tensors; BM25 is one corpus-wide term-major CSR.  Host-side
``CorpusMeta`` keeps what the device never needs (texts, sha1s, names).
The field names and layouts are the reference's, so an index saved by
either package loads in the other (index/store.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

ROW_PAD = 1024
KIND_CONTENT = 0
KIND_SERIALIZED_TABLE = 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _move(obj, device):
    """A copy of a tensor dataclass with every tensor field on ``device``."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (torch.Tensor, SparseIndex, ShardedSparseIndex)):
            v = v.to(device)
        kw[f.name] = v
    return type(obj)(**kw)


@dataclasses.dataclass
class SparseIndex:
    """Corpus-wide BM25 term index (term-major CSR).

    Postings for term t: ``chunk_ids[indptr[t]:indptr[t+1]]`` with term
    frequencies ``tf[...]``; ``df`` per vocab slot, ``chunk_len`` per row,
    ``dl`` the per-posting doc length (``chunk_len[chunk_ids]``).
    """

    indptr: torch.Tensor      # i32 [V + 1]
    chunk_ids: torch.Tensor   # i32 [NNZ_pad]  (padded with the N_pad - 1 row)
    tf: torch.Tensor          # f32 [NNZ_pad]
    df: torch.Tensor          # f32 [V]
    chunk_len: torch.Tensor   # f32 [N_pad]
    avgdl: torch.Tensor       # f32 scalar
    dl: Optional[torch.Tensor] = None  # f32 [NNZ_pad]
    vocab_bits: int = 20
    max_postings: int = 0
    # slack beyond indptr[-1] in chunk_ids/tf (ops/span_gather.dma_slack)
    dma_pad: int = 0

    def to(self, device) -> "SparseIndex":
        return _move(self, device)


@dataclasses.dataclass
class ShardedSparseIndex:
    """Row-range-sharded BM25 index: one CSR per dense shard
    (``parallel/sharded_sparse.py``).

    Postings are partitioned by chunk row range, so every row's postings
    live on the shard that holds its dense rows and per-shard totals are
    complete.  The leading axis stacks the CSRs this process holds: all S
    of them when ``mesh`` is None (the JAX package's one-device stacked
    form), else the one of this rank's shard (its index over ``axis`` of
    ``mesh``), whose candidates merge over that axis.  Global statistics
    (``df``, ``chunk_len``, ``avgdl``) are replicated, so scores equal the
    unsharded kernel's.
    """

    indptr: torch.Tensor      # i32 [S_held, V + 1]
    chunk_ids: torch.Tensor   # i32 [S_held, L] GLOBAL corpus rows, zero-padded
    tf: torch.Tensor          # f32 [S_held, L]
    df: torch.Tensor          # f32 [V]       (global, replicated)
    chunk_len: torch.Tensor   # f32 [N_pad]   (global, replicated)
    avgdl: torch.Tensor       # f32 scalar
    dl: Optional[torch.Tensor] = None  # f32 [S_held, L] per-posting doc length
    vocab_bits: int = 20
    max_postings: int = 0
    n_shards: int = 1
    mesh: Optional[object] = None  # DeviceMesh of a rank's one-shard form
    axis: object = "data"          # mesh axis (or axes) the shards lie on

    def to(self, device) -> "ShardedSparseIndex":
        return _move(self, device)


@dataclasses.dataclass
class CorpusIndex:
    """The whole searchable corpus as tensors on one device."""

    emb: torch.Tensor         # f32|bf16 [N_pad, D] — zero-padded rows
    doc_id: torch.Tensor      # i32 [N_pad]
    page: torch.Tensor        # i32 [N_pad]  (1-based page numbers)
    year: torch.Tensor        # i32 [N_pad]
    company_id: torch.Tensor  # i32 [N_pad]
    kind: torch.Tensor        # i32 [N_pad]
    page_seg: torch.Tensor    # i32 [N_pad] — global page-segment id (doc, page)
    chunk_in_doc: torch.Tensor  # i32 [N_pad]
    valid: torch.Tensor       # bool [N_pad]
    sparse: Optional[SparseIndex]  # or a ShardedSparseIndex
    emb_scale: Optional[torch.Tensor] = None  # f32 [N_pad] for an int8 store
    n_chunks: int = 0
    n_pages: int = 0
    n_docs: int = 0
    dim: int = 0

    @property
    def n_pad(self) -> int:
        # the row columns: a rank of a row-sharded store holds only its
        # rows of emb / emb_scale (parallel/sharded_search.shard_rows)
        return self.valid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.emb.device

    def to(self, device) -> "CorpusIndex":
        return _move(self, device)


@dataclasses.dataclass
class DocMeta:
    sha1: str
    company: str
    year: Optional[int]
    n_chunks: int
    n_pages: int


@dataclasses.dataclass
class CorpusMeta:
    """Host-side companions to CorpusIndex (never on the device)."""

    docs: List[DocMeta]
    companies: List[str]                   # company_id → name
    chunk_texts: List[str]                 # row → chunk text
    page_texts: Dict[int, str]             # page_seg id → page markdown
    page_seg_info: List[Tuple[int, int]]   # page_seg id → (doc_id, page)

    def company_id(self, name: str) -> int:
        try:
            return self.companies.index(name)
        except ValueError:
            return -1
