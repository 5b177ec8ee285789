"""Inner-product scores of query vectors against store rows, and a top-k
kept over row chunks.

Score forms (``mode``):

* ``f32``: f32 queries against the f32 rows, IEEE f32 products (TF32 off);
  the answer recall is measured against.
* ``bf16``: f32 queries against the rows rounded to bf16, in f64.
* ``int8``: per-row symmetric int8 codes of the rows and of each query
  (scale = max |x| / 127, codes = round half to even of x / scale, clamped
  to +-127); the code products summed exactly, then times the query's
  scale, then times the row's scale, in f32.
* ``int4``: the same with rows coded to +-7 (scale = max |x| / 7); the
  control for an int8 store.
"""

from __future__ import annotations

from typing import Tuple

import torch

MODES = ("f32", "bf16", "int8", "int4")
_EPS = 1e-12


def quantize(x: torch.Tensor, levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes f32 [n, D], scale f32 [n])`` with ``x ~ codes * scale``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / float(levels)
    inv = torch.where(scale > _EPS, 1.0 / scale.clamp(min=_EPS), torch.zeros_like(scale))
    codes = torch.round(xf * inv[:, None]).clamp(-levels, levels)
    return codes, scale


def scores(q: torch.Tensor, rows: torch.Tensor, mode: str) -> torch.Tensor:
    """``[B, n]`` scores of f32 queries ``q [B, D]`` against f32 rows
    ``rows [n, D]`` in the form ``mode``; f64 for ``bf16``, else f32."""
    if mode == "f32":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return q.float() @ rows.float().T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    if mode == "bf16":
        return q.double() @ rows.to(torch.bfloat16).double().T
    if mode in ("int8", "int4"):
        qc, qs = quantize(q, 127)
        rc, rs = quantize(rows, 127 if mode == "int8" else 7)
        acc = (qc.double() @ rc.double().T).float()
        return acc * qs[:, None] * rs[None, :]
    raise ValueError(f"unknown score mode {mode!r}")


class TopPool:
    """The ``keep`` best (score, row) pairs of each of ``B`` queries over
    the row chunks offered to :meth:`add`."""

    def __init__(self, B: int, keep: int, device, dtype=torch.float64):
        self.keep = keep
        self.vals = torch.full((B, keep), -float("inf"), dtype=dtype, device=device)
        self.rows = torch.full((B, keep), -1, dtype=torch.int64, device=device)

    def add(self, s: torch.Tensor, first_row: int, which: slice = slice(None)):
        """``s [b, n]``: the scores of rows ``first_row ..`` for the
        queries ``which`` of the pool."""
        k = min(self.keep, s.shape[1])
        v, j = torch.topk(s.to(self.vals.dtype), k, dim=1)
        vals = torch.cat([self.vals[which], v], 1)
        rows = torch.cat([self.rows[which], j + first_row], 1)
        order = torch.argsort(vals, dim=1, descending=True)[:, :self.keep]
        self.vals[which] = torch.gather(vals, 1, order)
        self.rows[which] = torch.gather(rows, 1, order)
