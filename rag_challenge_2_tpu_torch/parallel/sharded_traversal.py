"""Graph traversal on a row-sharded store: a rank's side of each hop.

The JAX package has no such module: its traversal
(``retrieval/traversal.py``) is written for one device, and over a
row-sharded store GSPMD inserts the collectives a hop needs.  A rank of
the port holds only its rows (``sharded_search.shard_rows``), so those
collectives are written here, and ``retrieval/traversal.py`` takes a
:class:`RowShard` as one optional argument (``shard=``):

* a hop's top-(k+1) is a sharded top-k (:meth:`RowShard.hop_topk`): each
  rank scores its rows with the kernels of the single-device hop (K1 / K3
  on f32 / bf16 stores, the plain hop on int8 ones), pads its candidates
  to exactly k + 1 columns (NEG_INF / row -1, so every rank ships the same
  shape), and they merge over the mesh (``sharded_search.merge_over``,
  equal values to the lowest row as on one device).  Triangulation's
  per-candidate ``q·x`` and ``‖x‖²`` are computed by the rank that owns
  the row, over the same ``[A, k+1, D]`` shape as on one device, and
  travel through the merge as payload columns; the candidate rows
  themselves never leave their rank;
* a row read (the walkers' current vectors, the hits' similarities) is a
  value of one owner: the owner writes it, every other rank writes zeros,
  and one all-reduce sum gives every rank the same f32 values
  (:meth:`RowShard.gather_rows`, :meth:`RowShard.sum`).  Adding zeros is
  exact, so the result equals the single-device read.

Rows are numbered in a frame: the rows one traversal walks, the whole
store or one document's window (:meth:`RowShard.window`).  A traversal
handed a ``RowShard`` gets this rank's rows of the frame (possibly none)
as its store; row ids in and out stay frame rows.  Every method is
called on every rank, in the same order and with the same shapes (the
collectives pair up by call), a rank that holds none of the frame's
rows included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.quant import gather_rows_f32
from ..ops.topk import NEG_INF
from .mesh import Axes, axis_index, axis_names
from .sharded_search import merge_over


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows of a traversal's frame.

    ``mesh`` / ``axes``: the mesh axes the rows shard over (flattened in
    order, as ``shard_rows`` places them); ``base``: the frame row of this
    rank's first local row; ``n_rows``: the frame's rows over all ranks
    (the same on every rank)."""

    mesh: DeviceMesh
    axes: Tuple[str, ...]
    base: int
    n_rows: int

    @classmethod
    def of_store(cls, mesh: DeviceMesh, axes: Axes, rows_per_shard: int,
                 n_rows: int) -> "RowShard":
        """This rank's part of a store placed by ``shard_rows(emb, mesh,
        axes)`` (``rows_per_shard`` rows a rank), over ``n_rows`` global
        rows."""
        return cls(mesh, axis_names(axes), axis_index(mesh, axes) * rows_per_shard,
                   n_rows)

    def window(self, start: int, length: int, n_local: int
               ) -> Tuple[int, int, "RowShard"]:
        """Frame rows ``[start, start + length)`` as a frame of their own:
        ``(lo, hi, shard)`` with ``[lo, hi)`` this rank's local rows of the
        window (of its ``n_local``; empty where it holds none) and
        ``shard`` the rank's part of the window's frame."""
        lo = min(max(start - self.base, 0), n_local)
        hi = min(max(start + length - self.base, lo), n_local)
        return lo, hi, dataclasses.replace(self, base=self.base + lo - start,
                                           n_rows=length)

    def hop_topk(self, vals: torch.Tensor, ids: torch.Tensor,
                 payload: Sequence[torch.Tensor] = ()) -> Tuple[torch.Tensor, ...]:
        """The top-k over the mesh of every rank's ``[A, k]`` candidates
        (``ids`` local rows, descending values; masked rows and pad
        columns at NEG_INF: every rank ships the same shape).  Returns
        ``(vals [A, k], frame rows [A, k], *payload)``: ties to the lowest
        row, -1 where fewer than ``k`` rows were eligible; ``payload``
        columns (f32, ``vals``' shape) follow their candidates."""
        rows = torch.where(vals > NEG_INF / 2, ids.to(torch.int32) + self.base,
                           torch.full_like(ids, -1, dtype=torch.int32))
        return merge_over(vals, rows, self.mesh, self.axes, vals.shape[1], payload)

    def local_rows(self, emb: torch.Tensor, row_scale: Optional[torch.Tensor],
                   idx: torch.Tensor) -> torch.Tensor:
        """f32 ``[*idx.shape, D]``: the rows of frame ids ``idx`` that this
        rank holds (``emb``: its local rows, dequantized for an int8
        store), zeros elsewhere and for ``-1``."""
        if emb.shape[0] == 0:
            return torch.zeros((*idx.shape, emb.shape[1]), dtype=torch.float32,
                               device=emb.device)
        local = idx.long() - self.base
        own = (idx >= 0) & (local >= 0) & (local < emb.shape[0])
        v = gather_rows_f32(emb, row_scale, torch.where(own, local, 0))
        return torch.where(own[..., None], v, torch.zeros((), device=v.device))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the mesh (in place, returned), one all-reduce
        an axis; every rank gets the same values."""
        for a in self.axes:
            dist.all_reduce(x, group=self.mesh.get_group(a))
        return x

    def gather_rows(self, emb: torch.Tensor, row_scale: Optional[torch.Tensor],
                    idx: torch.Tensor) -> torch.Tensor:
        """The f32 rows of frame ids ``idx`` (``>= 0``) on every rank: each
        row from its owner (:meth:`local_rows`), then :meth:`sum`."""
        return self.sum(self.local_rows(emb, row_scale, idx))
