"""The planner of ``scan_float`` (``csrc/float_scan.cuh``), the f32 / bf16
scoring kernel that K1 (:mod:`.dense_topk`) and K3's float regime
(:mod:`.stream_topk`: f32 stores, and bf16 stores that the bf16_tc regime
does not take) both launch.

The kernel takes its whole launch geometry from here, so that the CPU
tests reach it: the query tile sized to the batch, the rows a thread
holds, the row chunk each block of the persistent grid owns (the store is
read once per call), the rows a TMA stage brings, the blocks per SM and
the stage ring that fits the shared memory.  The constants mirror the
header's; a card test holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Tuple

THREADS = 256
WARPS = THREADS // 32
CHUNK_BYTES = 128           # D bytes per stage
CAND_CAP = 32               # gated candidates buffered per query
SEED_BITS = 16              # bits of a chunk's first threshold (radix select)
SCRATCH = 4                 # values one gate pass notes per thread
MAX_STAGES = 8
SMEM_BLOCK_MAX = 232448     # 227 KB: one block per SM
SMEM_SM = 233472            # 228 KB per SM
SMEM_RESERVED = 1024        # per block, taken by the runtime
MAX_BOX_ROWS = 256          # a TMA box dimension holds at most 256

# query tile -> (queries per warp TQ, warps side by side QG, rows per lane TR)
TILES: Dict[int, Tuple[int, int, int]] = {
    8: (8, 1, 2),
    16: (8, 2, 2),
    32: (16, 2, 2),
    64: (16, 4, 4),
    96: (12, 8, 4),
    128: (16, 8, 4),
}


def tile_rows(query_tile: int) -> int:
    """Store rows of one tile: 32 lanes x TR rows x 8 / QG warp rows."""
    _, qg, tr = TILES[query_tile]
    return 32 * tr * (WARPS // qg)


FLOAT_CONSTANTS = (
    THREADS, CHUNK_BYTES, CAND_CAP, SEED_BITS, SCRATCH, MAX_STAGES, SMEM_BLOCK_MAX, SMEM_SM,
    SMEM_RESERVED, *(tile_rows(t) for t in TILES))


def smem_bytes(query_tile: int, rows: int, elt: int, k: int,
               stages: int) -> Tuple[int, int]:
    """``(bytes of one stage, bytes the block requests)`` for a tile of
    ``rows`` store rows of ``elt``-byte elements: the header's
    ``float_smem``."""
    stage = rows * CHUNK_BYTES + query_tile * (CHUNK_BYTES // elt) * 4
    o = stages * stage
    o += 2 * query_tile * k * 4                 # the carried top-k
    o += 2 * query_tile * CAND_CAP * 4          # the candidate lists
    o += 2 * query_tile * 4                     # their counts, the thresholds
    o += SEED_BITS * WARPS * TILES[query_tile][0] * 4   # the radix select's counts
    o += 2 * rows                               # row codes, two tiles
    o = -(-o // 8) * 8
    o += THREADS * SCRATCH * 8                  # the gate's scratch lists
    o += MAX_STAGES * 8                         # mbarriers
    return stage, o + 1024                      # + the alignment slack


def stages_for(query_tile: int, rows: int, elt: int, k: int,
               blocks_per_sm: int) -> int:
    """The ring depth that fits ``blocks_per_sm`` blocks on an SM (the
    header's ``float_scan_stages``); below 2 the tile does not fit."""
    budget = (SMEM_BLOCK_MAX if blocks_per_sm == 1
              else SMEM_SM // blocks_per_sm - SMEM_RESERVED)
    stage, fixed = smem_bytes(query_tile, rows, elt, k, 0)
    return max(0, min(MAX_STAGES, (budget - fixed) // stage))


@dataclass(frozen=True)
class FloatPlan:
    """How one ``scan_float`` call is cut."""
    query_tile: int         # queries a block scores (8 .. 128)
    tile_rows: int          # store rows per tile
    rows_per_chunk: int     # rows a block owns
    n_chunks: int           # blocks of the grid
    box_rows: int           # rows a stage brings (< tile_rows: one small tile)
    blocks_per_sm: int
    stages: int
    smem: int               # bytes of shared memory a block requests
    store_passes: int = 1   # HBM reads of the store per call


@lru_cache(maxsize=512)
def float_plan(B: int, N: int, k: int, elt: int, sms: int) -> FloatPlan:
    """The grid for ``B`` queries over ``N`` rows of ``elt``-byte elements
    on a card of ``sms`` SMs.

    The query tile is the smallest that holds the batch.  A tile runs two
    blocks per SM where its accumulators and a ring of two stages allow
    it, else one.  Each block owns one contiguous chunk of whole tiles for
    all queries; when the store has fewer tiles than the grid has blocks,
    the chunks shrink to ``ceil(N / blocks)`` rows (a multiple of 32) and
    a stage brings only those, so a small store still fills the SMs."""
    if not 1 <= B <= max(TILES):
        raise ValueError(f"scan_float takes 1..{max(TILES)} queries, got {B}")
    qt = min(t for t in TILES if t >= B)
    tq, _, tr = TILES[qt]
    rows = tile_rows(qt)
    bps = 2 if tq * tr <= 16 and stages_for(qt, rows, elt, k, 2) >= 2 else 1
    blocks = bps * sms
    tiles = -(-N // rows)
    if tiles > blocks:
        rows_per_chunk = -(-tiles // blocks) * rows
        box_rows = rows
    else:
        rows_per_chunk = min(rows, -(-(-(-N // blocks)) // 32) * 32)
        box_rows = rows_per_chunk
        if box_rows > MAX_BOX_ROWS:                 # whole boxes only
            box_rows = -(-box_rows // MAX_BOX_ROWS) * MAX_BOX_ROWS
    stages = stages_for(qt, rows, elt, k, bps)
    if stages < 2:
        raise ValueError(f"scan_float: no stage ring fits (tile {qt} x {rows}, k {k})")
    return FloatPlan(qt, rows, rows_per_chunk, -(-N // rows_per_chunk), box_rows,
                     bps, stages, smem_bytes(qt, rows, elt, k, stages)[1])


_SMS: Dict[int, int] = {}


def sm_count(dev) -> int:
    """The card's SM count, read once per device."""
    import torch

    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]
