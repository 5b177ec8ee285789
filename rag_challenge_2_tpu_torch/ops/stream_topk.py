"""Kernel K3: streaming scan with a carried top-k (``csrc/stream_topk.cu``).

Port of the TPU kernel ``rag_challenge_2_tpu/ops/pallas_topk_stream.py``
(``stream_dense_topk``), which is also the engine of the JAX package's
bounded-memory exact scan ``ops/topk.blocked_topk``: the store is read in
row tiles, each query's top-k is carried on chip, and a tile is merged
only when one of its scores beats the current k-th.  The ``[B, N]`` score
matrix never exists, which is what lets a 10M-row store be scanned.  The
source note in the ``.cu`` file says what bounds each form on the H100
and how it is laid out.  The int8 forms run on the tensor cores
(``wgmma`` s8) in one of two regimes that :func:`plan` picks from the
batch: *small* (at most 16 code rows: B <= 16, or B <= 8 in 2-pass; the
engine's routed slots) keeps the code block resident in shared memory and
is bound by the store read; *large* (up to 256 code rows) stages the
query's D-chunks beside 128-row store tiles.  Either reads the store from
HBM once per call.  The f32 and bf16 forms (regime *float*) run
``scan_float`` of ``csrc/float_scan.cuh``, the kernel K1 shares: IEEE f32
FMA on the CUDA cores, a query tile of 8 to 128 picked from the batch and
one store read per call as well.

One wrapper, :func:`stream_topk`, takes every form the scan has:

* an f32 or bf16 store with f32 queries, scored in IEEE f32;
* an int8 store with int8 query codes: ``acc · q_scale · row_scale``;
* the 2-pass int8 query (``q`` stacks ``[hi; lo]`` codes, ``2B`` rows):
  ``(acc_hi · s_hi + acc_lo · s_lo) · row_scale``;
* the centroid-residual bias ``+ qc[b, assign[row]]`` on either int8 form,
  with ``qc = q · centroidsᵀ`` computed by the caller.

Its result follows ``blocked_topk`` and the Pallas kernel: the top
``k_eff = min(k, N)`` eligible rows by (value desc, row asc), and slots
past the eligible rows hold row -1 and NEG_INF.

:func:`stream_topk` takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import device  # noqa: F401  (full-f32 matmuls for the plain version)
from ..utils import kernels
from .float_scan import FLOAT_CONSTANTS, FloatPlan, float_plan, sm_count
from .quant import I8_EXACT_F32_DIM, i8_dot, int8_epilogue
from .topk import BLOCK_ROWS, NEG_INF, stable_topk

MAX_K = 64
MAX_QUERIES = 128
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# The planner's constants.  The library exports its own values
# (``rc2_stream_topk_constants``, in this order) and a card test holds
# the two equal.
INT8_TILE_ROWS = 128        # int8: store rows per tile (the TMA box)
SMALL_CODE_ROWS = 16        # int8 small regime: code rows, kept resident
SMALL_BLOCKS_PER_SM = 2
LARGE_BLOCKS_PER_SM = 1
LARGE_QUERY_TILES = (64, 128, 256)   # int8 large regime: code rows per tile
CAND_CAP = 16               # gated candidates buffered per query (int8)
MERGE_GROUP = 64            # chunk lists merged per block and level
CONSTANTS = (INT8_TILE_ROWS, SMALL_CODE_ROWS, SMALL_BLOCKS_PER_SM,
             LARGE_BLOCKS_PER_SM, *LARGE_QUERY_TILES, CAND_CAP, *FLOAT_CONSTANTS)
REGIMES = ("float", "int8_small", "int8_large")


@dataclass(frozen=True)
class Plan:
    """How one K3 call is cut: the regime, the query tile (code rows for
    int8), the row chunk each block owns, and how often the call reads
    the store from HBM.  ``cut`` is the f32 / bf16 kernel's full plan."""
    regime: str
    query_tile: int
    tile_rows: int
    rows_per_chunk: int
    n_chunks: int
    store_passes: int
    cut: Optional[FloatPlan] = None


def plan(B: int, two_pass: bool, int8: bool, N: int, sms: int, k: int = 30,
         elt: int = 4) -> Plan:
    """The kernel's grid for B logical queries over N rows on a card of
    ``sms`` SMs.  int8: the small regime up to 16 code rows (2B in
    2-pass), else the smallest large query tile that holds them; a
    persistent grid of one (large) or two (small) blocks per SM.
    f32 / bf16 (``elt`` bytes per element, top ``k``): the query tile of 8
    to 128 that holds the batch, as ``float_scan.float_plan`` cuts it.
    Either way each block owns a contiguous row chunk for all queries, so
    the call reads the store once."""
    if not int8:
        cut = float_plan(B, N, min(k, N), elt, sms)
        return Plan("float", cut.query_tile, cut.tile_rows, cut.rows_per_chunk,
                    cut.n_chunks, cut.store_passes, cut)
    rows = 2 * B if two_pass else B
    if rows <= SMALL_CODE_ROWS:
        regime, tile_q, blocks = "int8_small", SMALL_CODE_ROWS, SMALL_BLOCKS_PER_SM * sms
    else:
        regime = "int8_large"
        tile_q = min(t for t in LARGE_QUERY_TILES if t >= rows)
        blocks = LARGE_BLOCKS_PER_SM * sms
    tile_rows = INT8_TILE_ROWS
    tiles = -(-N // tile_rows)
    chunks = max(1, min(tiles, blocks))
    rows_per_chunk = -(-tiles // chunks) * tile_rows
    return Plan(regime, tile_q, tile_rows, rows_per_chunk, -(-N // rows_per_chunk), 1)


def scratch_chunks(n_chunks: int) -> int:
    """Scratch lists per query: the chunks' candidates plus the first merge
    level's groups (the library's ``rc2_stream_topk_scratch_chunks``)."""
    return n_chunks + -(-n_chunks // MERGE_GROUP)


def block_scores(
    q: torch.Tensor, e: torch.Tensor, *,
    q_scale: Optional[torch.Tensor] = None,
    q_scale_lo: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
    assign: Optional[torch.Tensor] = None,
    qc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[B, n]`` f32 scores of the queries against store rows ``e`` in the
    kernel's forms (see the module docstring), each product and sum
    rounded in the order of the JAX package's ``blocked_topk``."""
    if e.dtype != torch.int8:
        return q.float() @ e.float().T
    s = int8_epilogue(i8_dot(q, e), row_scale[None, :], q_scale, q_scale_lo)
    if assign is not None:
        s = s + qc[:, assign.long()]
    return s


def stream_topk_plain(
    q: torch.Tensor, emb: torch.Tensor, k: int,
    mask: Optional[torch.Tensor] = None, *,
    q_scale: Optional[torch.Tensor] = None,
    q_scale_lo: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
    assign: Optional[torch.Tensor] = None,
    qc: Optional[torch.Tensor] = None,
    block: int = BLOCK_ROWS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K3: a row-blocked scan with one
    ``torch.matmul`` per block, a stable descending sort of the block, and
    a stable merge with the carried top-k (carry first, so ties go to the
    lowest row).  ``mask`` may be ``[N]`` or ``[B, N]``.  Returns
    ``(f32 [B, k_eff], i32 [B, k_eff])``, -1 rows / NEG_INF past the
    eligible rows."""
    N = emb.shape[0]
    B = q.shape[0] if q_scale_lo is None else q.shape[0] // 2
    k_eff = min(k, N)
    dev = q.device
    top_v = torch.full((B, k_eff), NEG_INF, dtype=torch.float32, device=dev)
    top_i = torch.full((B, k_eff), -1, dtype=torch.int64, device=dev)
    for s0 in range(0, N, block):
        s1 = min(N, s0 + block)
        sl = slice(s0, s1)
        s = block_scores(
            q, emb[sl], q_scale=q_scale, q_scale_lo=q_scale_lo,
            row_scale=None if row_scale is None else row_scale[sl],
            assign=None if assign is None else assign[sl], qc=qc)
        if mask is not None:
            m = mask[sl] if mask.dim() == 1 else mask[:, sl]
            s = torch.where(m.bool() if m.dim() == 2 else m.bool()[None, :], s,
                            torch.full_like(s, NEG_INF))
        v, j = stable_topk(s, min(k_eff, s1 - s0))
        cv = torch.cat([top_v, v], dim=1)
        ci = torch.cat([top_i, j + s0], dim=1)
        # masked rows score NEG_INF and sort after the carry's (NEG_INF,
        # -1) fillers, so they never enter
        top_v, nj = stable_topk(cv, k_eff)
        top_i = torch.gather(ci, 1, nj)
    return top_v.contiguous(), top_i.to(torch.int32)


_LIB = None


def _lib():
    """The library, its argument types declared once at load."""
    global _LIB
    if _LIB is None:
        lib = kernels.load_library("stream_topk")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rc2_stream_topk.restype = I
        lib.rc2_stream_topk.argtypes = [P, P, I, I] + [P] * 6 + [I] * 9 + [P] * 5
        lib.rc2_stream_topk_constants.restype = I
        lib.rc2_stream_topk_constants.argtypes = [P, I]
        lib.rc2_stream_topk_scratch_chunks.restype = I
        lib.rc2_stream_topk_scratch_chunks.argtypes = [I]
        lib.rc2_stream_topk_float_stages.restype = I
        lib.rc2_stream_topk_float_stages.argtypes = [I] * 6
        _LIB = lib
    return _LIB


def library_constants() -> Tuple[int, ...]:
    """The library's own planner constants, in the order of
    :data:`CONSTANTS` (builds the library)."""
    buf = (ctypes.c_int * 64)()
    n = _lib().rc2_stream_topk_constants(ctypes.cast(buf, ctypes.c_void_p), 64)
    return tuple(buf[:n])


def _check_cuda_args(q, emb, k, mask, q_scale, q_scale_lo, row_scale, assign,
                     qc) -> int:
    """Raise on anything K3 does not take; returns the logical batch B."""
    if emb.dtype not in _KINDS:
        raise ValueError(f"K3 takes an f32, bf16 or int8 store, got {emb.dtype}")
    if emb.dim() != 2 or not emb.is_contiguous():
        raise ValueError("K3 takes a contiguous store [N, D]")
    N, D = emb.shape
    if not 1 <= N < 2**31:
        raise ValueError(f"K3 takes 1 <= N < 2**31 rows, got {N}")
    if q.dim() != 2 or not q.is_contiguous() or q.shape[1] != D:
        raise ValueError("K3 takes contiguous queries [B, D] with the store's D")
    int8 = emb.dtype == torch.int8
    if int8:
        if q.dtype != torch.int8:
            raise ValueError("K3 takes int8 query codes against an int8 store")
        if D > I8_EXACT_F32_DIM:
            raise ValueError(f"K3 takes int8 rows of D <= {I8_EXACT_F32_DIM}, got {D}")
        B = q.shape[0] // 2 if q_scale_lo is not None else q.shape[0]
        if q_scale_lo is not None and q.shape[0] != 2 * B:
            raise ValueError("the 2-pass query stacks 2B rows [hi; lo]")
        for name, t, n in (("q_scale", q_scale, B), ("q_scale_lo", q_scale_lo, B),
                           ("row_scale", row_scale, N)):
            if name == "q_scale_lo" and t is None:
                continue
            if t is None or t.dtype != torch.float32 or t.shape != (n,) \
                    or not t.is_contiguous():
                raise ValueError(f"K3 takes a contiguous f32 {name} [{n}]")
        if assign is not None:
            if assign.dtype != torch.int32 or assign.shape != (N,) \
                    or not assign.is_contiguous():
                raise ValueError("K3 takes a contiguous i32 assign [N]")
            if qc is None or qc.dtype != torch.float32 or qc.dim() != 2 \
                    or qc.shape[0] != B or not qc.is_contiguous():
                raise ValueError("K3 takes a contiguous f32 qc [B, n_codes]")
        elif qc is not None:
            raise ValueError("qc goes with assign")
    else:
        if q.dtype != torch.float32:
            raise ValueError("K3 takes f32 queries against an f32 or bf16 store")
        if any(t is not None for t in (q_scale, q_scale_lo, row_scale, assign, qc)):
            raise ValueError("scales and the residual bias need an int8 store")
        B = q.shape[0]
    if not 1 <= B <= MAX_QUERIES:
        raise ValueError(f"K3 takes 1..{MAX_QUERIES} queries, got {B}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K3 supports 1 <= k <= {MAX_K}, got {k}")
    if mask is not None and (
        mask.dtype != torch.bool or mask.shape != (N,) or not mask.is_contiguous()
    ):
        raise ValueError("K3 takes a contiguous bool row mask [N] shared by "
                         "all queries; a [B, N] mask is not taken")
    for t in (q_scale, q_scale_lo, row_scale, assign, qc, mask):
        if t is not None and t.device != q.device:
            raise ValueError("every operand must be on the queries' device")
    if emb.device != q.device:
        raise ValueError("queries and store must be on one device")
    return B


def stream_topk(
    q: torch.Tensor, emb: torch.Tensor, k: int,
    mask: Optional[torch.Tensor] = None, *,
    q_scale: Optional[torch.Tensor] = None,
    q_scale_lo: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
    assign: Optional[torch.Tensor] = None,
    qc: Optional[torch.Tensor] = None,
    block: int = BLOCK_ROWS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of a streaming scan over ``emb``.

    Args:
        q: ``[B, D]`` f32 queries (f32 / bf16 store) or int8 codes (int8
            store; ``[2B, D]`` stacked ``[hi; lo]`` with ``q_scale_lo``).
        emb: ``[N, D]`` contiguous store, f32, bf16 or int8.
        k: neighbours, 1..64; ``k_eff = min(k, N)`` are returned.
        mask: optional bool ``[N]`` shared by the queries (the plain
            version on the CPU also takes ``[B, N]``).
        q_scale, q_scale_lo, row_scale: f32 int8 scales (``[B]``, ``[B]``,
            ``[N]``).
        assign, qc: the residual bias, i32 ``[N]`` and f32 ``[B, n_codes]``.
        block: rows per step of the plain version (the kernel's tiles are
            its own).

    Returns ``(values f32 [B, k_eff] descending, rows i32 [B, k_eff])``;
    ties go to the lowest row; slots past the eligible rows hold -1 and
    NEG_INF.
    """
    kw = dict(q_scale=q_scale, q_scale_lo=q_scale_lo, row_scale=row_scale,
              assign=assign, qc=qc)
    if q.device.type == "cpu":
        return stream_topk_plain(q, emb, k, mask, block=block, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {q.device}")
    B = _check_cuda_args(q, emb, k, mask, **kw)
    N, D = emb.shape
    k_eff = min(k, N)
    two_pass = q_scale_lo is not None
    mode = 0 if emb.dtype != torch.int8 else (2 if two_pass else 1)
    lib = _lib()
    dev = q.device
    pl = plan(B, two_pass, mode != 0, N, sm_count(dev), k_eff, emb.element_size())
    cut = pl.cut
    # one buffer for the chunks' candidate lists and the merge levels'
    # (values, then rows) and one for the result
    n_cand = B * scratch_chunks(pl.n_chunks) * k_eff
    cand = torch.empty(2 * n_cand, dtype=torch.float32, device=dev)
    out = torch.empty((2, B, k_eff), dtype=torch.float32, device=dev)
    out_v, out_i = out[0], out[1].view(torch.int32)
    # the residual bias as [n_codes, B]: the four lanes that hold one row's
    # neighbouring queries then read one sector
    qc_t = None if qc is None else qc.t().contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.rc2_stream_topk(
        q.data_ptr(), emb.data_ptr(), _KINDS[emb.dtype], mode, ptr(q_scale),
        ptr(q_scale_lo), ptr(row_scale), ptr(assign), ptr(qc_t), ptr(mask), B, N, D,
        k_eff, pl.query_tile, pl.rows_per_chunk, pl.n_chunks,
        cut.box_rows if cut else 0, cut.blocks_per_sm if cut else 0,
        cand.data_ptr(), cand.data_ptr() + 4 * n_cand, out_v.data_ptr(),
        out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check_launch(lib, rc, "stream_topk")
    stream_topk.launches += 1
    stream_topk.regime_launches[pl.regime] += 1
    return out_v, out_i


stream_topk.launches = 0
# launches by regime ("float", "int8_small", "int8_large")
stream_topk.regime_launches = dict.fromkeys(REGIMES, 0)


def stream_dense_topk(
    q: torch.Tensor, emb: torch.Tensor, k: int,
    mask: Optional[torch.Tensor] = None,
    tile_n: int = 2048,
    exact: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``stream_dense_topk`` contract: ``q`` is cast to
    the store's dtype first (a bf16 store scores bf16-rounded queries; a
    product of two bf16 values is exact in f32), ``mask`` is a row-shared
    ``[N]`` array whose entries > 0 are eligible.  ``tile_n`` is the
    Pallas kernel's tile and ``exact=False`` its fast matmul precision:
    both are accepted, and every call computes the exact result."""
    del tile_n, exact
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("stream_dense_topk takes an f32 or bf16 store")
    qq = q.to(emb.dtype).float().contiguous()
    m = None if mask is None else (mask > 0).contiguous()
    return stream_topk(qq, emb, k, m)
