// Device code shared by K1 (dense_topk.cu) and K3 (stream_topk.cu):
//   * the total order of candidates and the sorted-list helpers;
//   * the 2-D TMA stage helper (the mbarrier helpers and the bounded
//     wait are in tma.cuh);
//   * the rank merge of a query's buffered candidates into its carried
//     top-k and the gate's out-of-line half;
//   * scan_float: the f32 / bf16 scoring kernel both libraries launch.
//
// scan_float computes, for f32 queries [B, D] and an f32 or bf16 store
// [N, D], every score in IEEE f32 FMA on the CUDA cores (a bf16 row is
// widened to f32; no TF32, no bf16 products) and keeps each query's top-k
// of the block's row chunk under (value desc, row asc).
//
// What bounds it on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32 outside the
// tensor cores = 128 FMA per SM and clock): a call reads the N x D store
// once and does B x N x D FMAs.  Up to about 16 queries against f32 rows
// (8 against bf16) the read is the larger time; above, the FMAs are.
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py, k = 30,
// D = 1024): at B = 8 over 250,000 rows the f32 store runs at 80% of the
// read bound and the bf16 store at 67% (the same FMAs per half the bytes:
// the product loop, not HBM, is then the longer side); the FMA-bound tiles
// (B >= 32, K3 at B = 127 over 1M rows) reach 40-54% of the FMA peak.
// There the shared-memory-to-register path is the limit, not FMA issue:
// a 16 x 4 register tile still needs 20 16-byte loads per 256 FMAs, each
// delivering 512 bytes to a warp's registers whether or not it is a
// broadcast.  A store of 10,240 rows is all fixed cost (launch, the first
// tile's threshold, the lists, the merge): 0.07-0.08 ms at B = 8 against a
// 0.006-0.013 ms read.  What the design does:
//   * one HBM read of the store per call: a persistent grid, each block
//     owning one contiguous row chunk for all of the call's queries.
//   * stages by TMA: a stage is one 128-byte D-chunk of a row tile (box
//     128 bytes x up to 512 rows, 128-byte swizzle) plus the queries' same
//     D-chunk [query tile][chunk] as f32, in a ring of 2-8 stages on
//     mbarriers; no thread spends an instruction on a copy.  The query
//     chunk comes from L2.  A stage that has not arrived after 4 s traps.
//     Rows that are not 16-byte aligned are loaded by the threads into the
//     same layout.
//   * a lane owns whole rows, a warp owns TQ queries: lane l of a warp
//     reads 16 bytes of its TR rows (conflict-free through the swizzle)
//     and the warp reads each query's 16 bytes as one broadcast, so a
//     score is finished in the lane's registers and no shuffle is needed.
//     TR x TQ accumulators per thread: TR row loads of 4 wavefronts and
//     TQ broadcasts of 1 per 4 TR TQ FMAs.  In the tiles of up to 32
//     accumulators a D-chunk's products are summed on their own and then
//     added to the row's total, so the rounding error grows with the
//     square root of the chunks, not of D.
//   * the query tile is sized to the batch (8, 16, 32, 64, 96, 128): the
//     block's 8 warps split into QG query groups x 8 / QG row groups.
//   * a carried per-query top-k in the block behind a register gate: a
//     finished score is tested against its query's k-th value in
//     straight-line code; the few that pass are noted in a per-thread
//     scratch list and taken out of line to the exact test under (value
//     desc, row asc) and to the query's candidate list in shared memory
//     (the lanes of a warp that offer to one query share one atomicAdd),
//     which a warp rank-merges into the sorted top-k, by shuffles and
//     ballots, when one list is full.  A value equal to the k-th with a
//     lower row passes the gate (>=) and wins the exact test.
//   * a chunk's first tile meets empty lists; its threshold comes from a
//     radix select over the tile's values in registers (16 bit steps of one
//     vote each), so only about k values per query leave the gate there
//     instead of all of them (measured: without it the first tile's
//     candidates cost more than the whole scan of a 250,000-row store).
// Each block writes its k candidates per query once; the caller merges
// the blocks' lists.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <cstring>
#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;
constexpr float kNegInf = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kChunk = 128;       // D bytes per stage (the TMA box's width)
constexpr int kScratch = 4;       // values one gate pass notes per thread
constexpr int kMaxStages = 8;
constexpr int kSmemBlockMax = 232448;   // 227 KB: one block per SM
constexpr int kSmemSM = 233472;         // 228 KB per SM
constexpr int kSmemReserved = 1024;     // per block, taken by the runtime
constexpr int kTmaError = 100000;       // + CUresult of a failed encode
constexpr int kMaxDevices = 64;         // devices whose attributes are remembered
constexpr int kDefaultDynamicSmem = 48 * 1024;   // a launch may ask this much unasked
constexpr int kFloatCandCap = 32;       // scan_float: gated candidates per query
constexpr int kSeedBits = 16;           // bits of a chunk's first threshold

// total order of candidates: higher value first, then lower row
__device__ __forceinline__ bool better(float v1, int r1, float v2, int r2) {
  return v1 > v2 || (v1 == v2 && r1 < r2);
}

__device__ __forceinline__ void warp_best(float& v, int& r) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int orow = __shfl_xor_sync(kFull, r, off);
    if (better(ov, orow, v, r)) {
      v = ov;
      r = orow;
    }
  }
}

// Entries of the sorted list (v, r)[0, k) that are better than (cv, cr).
__device__ __forceinline__ int count_better(const float* v, const int* r,
                                            int k, float cv, int cr) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (better(v[mid], r[mid], cv, cr)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                       int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Rank-merge up to 32 candidates (one per lane, in any order) into the
// sorted list (tv, ti)[0, k), by the warp that owns the list.  Every entry
// and candidate moves to its rank among both; the ranks come from shuffles
// and ballots alone, in a loop the compiler can unroll (no search through
// shared memory).  Empty slots, (-inf, INT_MAX) or (NEG_INF, -1), rank last.
__device__ __forceinline__ void merge_warp_list(float* tv, int* ti, int k, const float* cv_s,
                                                const int* cr_s, int n, int lane) {
  const bool c = lane < n;
  const float cv = c ? cv_s[lane] : -INFINITY;
  const int cr = c ? cr_s[lane] : INT_MAX;
  const float e0v = lane < k ? tv[lane] : -INFINITY;
  const int e0r = lane < k ? ti[lane] : INT_MAX;
  const float e1v = lane + 32 < k ? tv[lane + 32] : -INFINITY;
  const int e1r = lane + 32 < k ? ti[lane + 32] : INT_MAX;
  int pe0 = lane, pe1 = lane + 32, pc = 0;
  const int nn = (n + 7) & ~7;   // lanes past n hold (-inf, INT_MAX): no effect
#pragma unroll 8
  for (int t = 0; t < nn; ++t) {
    const float yv = __shfl_sync(kFull, cv, t);
    const int yr = __shfl_sync(kFull, cr, t);
    pe0 += better(yv, yr, e0v, e0r);
    pe1 += better(yv, yr, e1v, e1r);
    pc += better(yv, yr, cv, cr);
    const unsigned b0 = __ballot_sync(kFull, better(e0v, e0r, yv, yr));
    const unsigned b1 = __ballot_sync(kFull, better(e1v, e1r, yv, yr));
    if (lane == t) pc += __popc(b0) + __popc(b1);
  }
  __syncwarp();
  if (lane < k && pe0 < k) {
    tv[pe0] = e0v;
    ti[pe0] = e0r;
  }
  if (lane + 32 < k && pe1 < k) {
    tv[pe1] = e1v;
    ti[pe1] = e1r;
  }
  if (c && pc < k) {
    tv[pc] = cv;
    ti[pc] = cr;
  }
  __syncwarp();
}

// offer() for scan_float, whose lanes mostly offer to the same query at
// once (a warp's lanes hold 32 rows of one query): the lanes of a warp that
// offer to one query take their slots with a single atomicAdd.  (A variant
// that the whole warp calls after one vote per 32 rows, with no scratch
// list, was 4-8% slower on the card at the large shapes: more calls.)
__device__ __noinline__ bool offer_grouped(float v, int row, int q, int k,
                                           const float* top_v, const int* top_i, int* cnt,
                                           float* cand_v, int* cand_r, int cap) {
  if (!better(v, row, top_v[q * k + k - 1], top_i[q * k + k - 1])) return true;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned peers = __match_any_sync(__activemask(), q);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if ((int)lane == leader) base = atomicAdd(cnt + q, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  const int slot = base + __popc(peers & ((1u << lane) - 1u));
  if (slot >= cap) return false;
  cand_v[q * cap + slot] = v;
  cand_r[q * cap + slot] = row;
  return true;
}

// A float as an unsigned key of the same order, and back.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

// ============================================================ scan_float

// The thread layout of one query tile: QG warps side by side on TQ queries
// each, kWarps / QG warp rows of 32 lanes x TR store rows.
template <int TQ, int QG, int TR>
struct FloatTile {
  static constexpr int kQT = TQ * QG;               // queries per block
  static constexpr int kRG = kWarps / QG;           // warp rows
  static constexpr int kRows = 32 * TR * kRG;       // store rows per tile
  // two blocks per SM need <= 128 registers a thread
  static constexpr int kMinBlocks = TQ * TR <= 16 ? 2 : 1;
  // a D-chunk's products summed apart from the row's total (see the note
  // above) where the registers allow it; the 64-accumulator tiles sum in
  // one chain, as a plain f32 dot product does
  static constexpr bool kTwoLevel = TQ * TR <= 32;
};

struct FloatParams {
  const float* q;           // [B, D] f32
  const void* emb;          // [N, D] row-major, f32 or bf16
  const uint8_t* mask;      // [N] row mask shared by all queries, or null
  int B;
  int N;
  int D;
  int k;
  int rows_per_chunk;       // rows a block owns
  int box_rows;             // rows a stage brings (the tile's, or fewer when
                            // the chunk is smaller than one tile)
  int tma_box;              // rows per TMA box (<= 256), dividing box_rows
  int n_stages;
  int tma;                  // 1: stages arrive by TMA; 0: loaded by the threads
  float* cand_v;            // [B, n_chunks, k]
  int* cand_i;
};

// Byte offsets in the block's shared memory (after aligning it to 1024).
struct FloatSmem {
  int stage;   // bytes of one ring stage: the row tile's chunk + the queries'
  int top_v, top_i, cand_v, cand_i, cnt, thr, rcnt, meta, scratch, bar;
  int total;   // bytes to request, with the alignment slack
};

// `tq`: queries per warp (the radix select counts per warp).
__host__ __device__ inline FloatSmem float_smem(int qt, int tq, int rows, int elt, int k,
                                                int n_stages) {
  FloatSmem L;
  L.stage = rows * kChunk + qt * (kChunk / elt) * 4;
  int o = n_stages * L.stage;
  L.top_v = o;
  o += qt * k * 4;
  L.top_i = o;
  o += qt * k * 4;
  L.cand_v = o;
  o += qt * kFloatCandCap * 4;
  L.cand_i = o;
  o += qt * kFloatCandCap * 4;
  L.cnt = o;
  o += qt * 4;
  L.thr = o;     // [qt] the first tile's threshold per query
  o += qt * 4;
  L.rcnt = o;    // [kSeedBits][kWarps][tq] each warp's counts per bit step
  o += kSeedBits * kWarps * tq * 4;
  L.meta = o;    // [2][rows] bytes per tile, double-buffered
  o += 2 * rows;
  o = round_up(o, 8);
  L.scratch = o;   // per thread: kScratch (value, bit) pairs of one gate pass
  o += kThreads * kScratch * 8;
  L.bar = o;
  o += kMaxStages * 8;
  L.total = o + 1024;
  return L;
}

// 16 raw bytes of a row -> 16 / sizeof(ET) floats
template <typename ET>
__device__ __forceinline__ void widen16(const uint4& raw, float* x) {
  if constexpr (std::is_same<ET, float>::value) {
    x[0] = __uint_as_float(raw.x);
    x[1] = __uint_as_float(raw.y);
    x[2] = __uint_as_float(raw.z);
    x[3] = __uint_as_float(raw.w);
  } else {
    // a bf16 is the high half of its f32
    x[0] = __uint_as_float(raw.x << 16);
    x[1] = __uint_as_float(raw.x & 0xffff0000u);
    x[2] = __uint_as_float(raw.y << 16);
    x[3] = __uint_as_float(raw.y & 0xffff0000u);
    x[4] = __uint_as_float(raw.z << 16);
    x[5] = __uint_as_float(raw.z & 0xffff0000u);
    x[6] = __uint_as_float(raw.w << 16);
    x[7] = __uint_as_float(raw.w & 0xffff0000u);
  }
}

// kSelectMasked: K1's contract (a masked row scores NEG_INF and stays
// selectable after every real score; empty slots sort last) against K3's
// (a masked row never enters; empty slots are row -1 at NEG_INF).
template <typename ET, int TQ, int QG, int TR, bool kSelectMasked>
__global__ void __launch_bounds__(kThreads, FloatTile<TQ, QG, TR>::kMinBlocks)
    scan_float(const __grid_constant__ CUtensorMap emb_map,
               const __grid_constant__ CUtensorMap q_map, FloatParams p) {
  using T = FloatTile<TQ, QG, TR>;
  constexpr int QT = T::kQT;
  constexpr int R = T::kRows;
  constexpr int CE = kChunk / (int)sizeof(ET);   // elements per D-chunk
  constexpr int E16 = 16 / (int)sizeof(ET);      // elements per 16 bytes
  // pieces unrolled in the product loop: a 48- or 64-accumulator tile over
  // bf16 rows is 384-512 FMAs a piece, and all eight would outgrow the
  // instruction cache (measured: 15% slower)
  constexpr int kPieceUnroll = TQ * TR * E16 >= 384 ? 4 : 8;

  // aligned to 1024 by an offset, not by integer arithmetic on the pointer:
  // the compiler then still knows the address space and emits LDS / STS
  // (through a generic pointer every access is a slower generic LD / ST)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int k = p.k;
  const int S = p.n_stages;
  static_assert(TQ * TR <= 64, "one pending bit per epilogue value");
  const FloatSmem L = float_smem(QT, TQ, R, (int)sizeof(ET), k, S);
  float* top_v = reinterpret_cast<float*>(smem + L.top_v);
  int* top_i = reinterpret_cast<int*>(smem + L.top_i);
  float* cand_v = reinterpret_cast<float*>(smem + L.cand_v);
  int* cand_r = reinterpret_cast<int*>(smem + L.cand_i);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  unsigned char* meta = smem + L.meta;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qg = warp % QG;            // this warp's queries: qg * TQ .. + TQ - 1
  const int lr0 = (warp / QG) * (32 * TR) + lane;   // its rows: lr0 + 32 j
  const int swz = lane & 7;            // (lr0 + 32 j) & 7: the row's swizzle
  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int r_begin = chunk * p.rows_per_chunk;
  const int r_end = min(p.N, r_begin + p.rows_per_chunk);
  const int n_tiles = (r_end - r_begin + R - 1) / R;
  const int n_dch = (p.D + CE - 1) / CE;
  const int total = n_tiles * n_dch;
  const int B = p.B;
  const int stage_bytes = p.box_rows * kChunk + QT * CE * 4;

  float* thr = reinterpret_cast<float*>(smem + L.thr);
  int* rcnt = reinterpret_cast<int*>(smem + L.rcnt);
  for (int i = tid; i < QT * k; i += kThreads) {
    top_v[i] = kSelectMasked ? -INFINITY : kNegInf;
    top_i[i] = kSelectMasked ? INT_MAX : -1;
  }
  for (int i = tid; i < QT; i += kThreads) {
    cnt[i] = 0;
    thr[i] = -INFINITY;
  }
  if (p.tma && tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(bars + s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage s = (tile s / n_dch, D-chunk s % n_dch) into ring slot s % S
  auto issue = [&](int s) {
    unsigned char* st = smem + (s % S) * L.stage;
    const uint32_t bar = smem_u32(bars + s % S);
    const int c = s % n_dch;
    mbar_expect_tx(bar, stage_bytes);
    for (int r = 0; r < p.box_rows; r += p.tma_box)
      tma_2d(smem_u32(st + r * kChunk), &emb_map, c * kChunk,
             r_begin + (s / n_dch) * R + r, bar);
    tma_2d(smem_u32(st + R * kChunk), &q_map, c * CE, 0, bar);
  };
  if (p.tma && tid == 0) {
    for (int s = 0; s < S && s < total; ++s) issue(s);
  }

  // the same stage, by the threads (rows that TMA does not take): element
  // by element into the swizzled layout, zeros past D, N and B
  auto load_by_threads = [&](int s, unsigned char* st) {
    const int c = s % n_dch;
    const int row0 = r_begin + (s / n_dch) * R;
    const ET* eg = static_cast<const ET*>(p.emb);
    for (int u = tid; u < R * CE; u += kThreads) {
      const int i = u / CE;
      const int e = u % CE;
      const int d = c * CE + e;
      const int row = row0 + i;
      ET v = ET(0.f);
      if (row < p.N && d < p.D) v = eg[(size_t)row * p.D + d];
      const int piece = e / E16;
      *reinterpret_cast<ET*>(st + i * kChunk + ((piece ^ (i & 7)) << 4) +
                             (e % E16) * (int)sizeof(ET)) = v;
    }
    float* qs = reinterpret_cast<float*>(st + R * kChunk);
    for (int u = tid; u < QT * CE; u += kThreads) {
      const int i = u / CE;
      const int d = c * CE + u % CE;
      qs[u] = (i < B && d < p.D) ? p.q[(size_t)i * p.D + d] : 0.f;
    }
  };

  // every query's buffered candidates into its sorted top-k (one warp per
  // query), buffers emptied
  auto merge_all = [&]() {
    for (int q = warp; q < QT; q += kWarps) {
      const int n = cnt[q];
      if (n == 0) continue;
      merge_warp_list(top_v + q * k, top_i + q * k, k, cand_v + q * kFloatCandCap,
                      cand_r + q * kFloatCandCap, min(n, kFloatCandCap), lane);
      if (lane == 0) cnt[q] = 0;
    }
  };

  float tot[TR][TQ];   // the rows' scores over the D-chunks so far
  for (int s = 0; s < total; ++s) {
    const int c = s % n_dch;
    const int t = s / n_dch;
    const int slot = p.tma ? s % S : 0;
    const int row0 = r_begin + t * R;
    unsigned char* st = smem + slot * L.stage;
    if (c == 0) {
      // the tile's rows: 0 not a candidate (past the chunk, or masked in
      // K3's contract), 1 scored, 2 masked but selectable at NEG_INF
      for (int i = tid; i < R; i += kThreads) {
        const int row = row0 + i;
        unsigned char code = 0;
        if (row < r_end) {
          const bool ok = p.mask == nullptr || p.mask[row] != 0;
          code = ok ? 1 : (kSelectMasked ? 2 : 0);
        }
        meta[(t & 1) * R + i] = code;
      }
#pragma unroll
      for (int j = 0; j < TR; ++j)
#pragma unroll
        for (int i = 0; i < TQ; ++i) tot[j][i] = 0.f;
    }
    if (p.tma) {
      mbar_wait(smem_u32(bars + slot), (s / S) & 1);
    } else {
      load_by_threads(s, st);
      __syncthreads();
    }

    // ---- products: 8 pieces of 16 bytes over the 128-byte chunk
    {
      float acc[TR][TQ];
#pragma unroll
      for (int j = 0; j < TR; ++j)
#pragma unroll
        for (int i = 0; i < TQ; ++i) acc[j][i] = T::kTwoLevel ? 0.f : tot[j][i];
      const unsigned char* rp = st + lr0 * kChunk;
      const float* qs = reinterpret_cast<const float*>(st + R * kChunk) + qg * TQ * CE;
#pragma unroll kPieceUnroll
      for (int piece = 0; piece < kChunk / 16; ++piece) {
        float x[TR][E16];
#pragma unroll
        for (int j = 0; j < TR; ++j)
          widen16<ET>(*reinterpret_cast<const uint4*>(rp + j * 32 * kChunk +
                                                      ((piece ^ swz) << 4)),
                      x[j]);
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
#pragma unroll
          for (int h = 0; h < E16 / 4; ++h) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qs + i * CE + piece * E16 + 4 * h);
#pragma unroll
            for (int j = 0; j < TR; ++j) {
              float a = acc[j][i];
              a = fmaf(qv.x, x[j][4 * h + 0], a);
              a = fmaf(qv.y, x[j][4 * h + 1], a);
              a = fmaf(qv.z, x[j][4 * h + 2], a);
              a = fmaf(qv.w, x[j][4 * h + 3], a);
              acc[j][i] = a;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < TR; ++j)
#pragma unroll
        for (int i = 0; i < TQ; ++i) tot[j][i] = T::kTwoLevel ? tot[j][i] + acc[j][i] : acc[j][i];
    }
    // the slot is free once every warp's products are done (the scores are
    // in registers), so it is refilled before the epilogue runs; the
    // barrier also makes the tile's row codes visible
    __syncthreads();
    if (p.tma && tid == 0 && s + S < total) issue(s + S);
    if (c != n_dch - 1) continue;

    // ---- epilogue
    int code[TR];
#pragma unroll
    for (int j = 0; j < TR; ++j) code[j] = meta[(t & 1) * R + lr0 + 32 * j];
    if (t == 0) {
      // The chunk's first tile meets empty lists, and everything would pass
      // the gate.  So the tile first finds, per query, a threshold that at
      // least k of its values reach: the k-th largest value's order key,
      // bit by bit from the top (a radix select over the values in
      // registers: one vote per bit and value, the warps' counts summed
      // through shared memory), cut after
      // kSeedBits bits.  The low bits stay zero, so the threshold lies at
      // or below the k-th value and nothing of the top-k is gated out.
      uint32_t prefix[TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i) prefix[i] = 0u;
      for (int b = 0; b < kSeedBits; ++b) {
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const uint32_t want = prefix[i] | (0x80000000u >> b);
          int c_i = 0;
#pragma unroll
          for (int j = 0; j < TR; ++j) {
            const float v = kSelectMasked && code[j] == 2 ? kNegInf : tot[j][i];
            c_i += __popc(__ballot_sync(kFull, code[j] != 0 && order_key(v) >= want));
          }
          if (lane == 0) rcnt[(b * kWarps + warp) * TQ + i] = c_i;
        }
        __syncthreads();
        // the query's count: its warp rows' (warps qg, qg + QG, ...)
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          int n_i = 0;
#pragma unroll
          for (int rg = 0; rg < T::kRG; ++rg) n_i += rcnt[(b * kWarps + rg * QG + qg) * TQ + i];
          if (n_i >= k) prefix[i] |= 0x80000000u >> b;
        }
      }
      if (warp < QG && lane == 0) {
#pragma unroll
        for (int i = 0; i < TQ; ++i)
          if (prefix[i] != 0u) {
            const float t0 = key_value(prefix[i]);
            if (t0 == t0) thr[qg * TQ + i] = t0;   // not a NaN pattern
          }
      }
      __syncthreads();
    }
    // gate each value in registers against its query's k-th value (and the
    // first tile's threshold); the ones that pass go to the query's
    // candidate list, which is merged only once some list is full
    float* sv = reinterpret_cast<float*>(smem + L.scratch) + tid * kScratch;
    int* sb = reinterpret_cast<int*>(smem + L.scratch + kThreads * kScratch * 4) +
              tid * kScratch;
    // the values in `todo`, through as many passes of this thread as its
    // scratch list needs.  Returns the values whose candidate list was full
    auto gate = [&](uint64_t todo) -> uint64_t {
      uint64_t full = 0;
      while (todo != 0ull) {
        uint64_t later = 0;
        int n = 0;
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          if (((todo >> (i * TR)) & ((1ull << TR) - 1)) == 0) continue;
          const int q = qg * TQ + i;
          const float kv = fmaxf(top_v[q * k + k - 1], thr[q]);
#pragma unroll
          for (int j = 0; j < TR; ++j) {
            const int bit = i * TR + j;
            const float v = kSelectMasked && code[j] == 2 ? kNegInf : tot[j][i];
            if (((todo >> bit) & 1ull) && v >= kv) {
              if (n < kScratch) {
                sv[n] = v;
                sb[n] = bit;
                ++n;
              } else {
                later |= 1ull << bit;   // no scratch slot: next pass
              }
            }
          }
        }
        // the noted values, in a rolled loop: one call site
        for (int m = 0; m < n; ++m) {
          const int bit = sb[m];
          if (!offer_grouped(sv[m], row0 + lr0 + 32 * (bit % TR), qg * TQ + bit / TR, k,
                             top_v, top_i, cnt, cand_v, cand_r, kFloatCandCap))
            full |= 1ull << bit;
        }
        todo = later;
      }
      return full;
    };
    // rows that are no candidates and queries past B never enter
    uint64_t todo = 0;
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j)
        if (qg * TQ + i < B && code[j] != 0) todo |= 1ull << (i * TR + j);
    while (true) {
      todo = gate(todo);
      if (!__syncthreads_or(todo != 0ull)) break;
      merge_all();  // every list: fresh k-th values let fewer values through
      __syncthreads();
    }
  }
  merge_all();
  __syncthreads();

  for (int q = warp; q < QT && q < B; q += kWarps) {
    for (int j = lane; j < k; j += 32) {
      const size_t o = ((size_t)q * n_chunks + chunk) * k + j;
      p.cand_v[o] = top_v[q * k + j];
      p.cand_i[o] = top_i[q * k + j];
    }
  }
}

// ---- host side

// The stage count that fits `blocks_per_sm` blocks of this tile on an SM.
inline int float_scan_stages(int qt, int tq, int rows, int elt, int k, int blocks_per_sm) {
  const int budget = blocks_per_sm == 1 ? kSmemBlockMax
                                        : kSmemSM / blocks_per_sm - kSmemReserved;
  const FloatSmem L0 = float_smem(qt, tq, rows, elt, k, 0);
  return std::max(0, std::min(kMaxStages, (budget - L0.total) / L0.stage));
}

template <typename ET, int TQ, int QG, int TR, bool kSelectMasked>
int launch_scan_float_tile(FloatParams p, int n_chunks, int blocks_per_sm,
                           cudaStream_t stream) {
  using T = FloatTile<TQ, QG, TR>;
  constexpr int CE = kChunk / (int)sizeof(ET);
  if (blocks_per_sm < 1 || blocks_per_sm > T::kMinBlocks) return (int)cudaErrorInvalidValue;
  if (p.box_rows < 8 || p.box_rows % 8 != 0 || p.box_rows > T::kRows ||
      (p.box_rows < T::kRows && p.rows_per_chunk > p.box_rows))
    return (int)cudaErrorInvalidValue;
  p.tma_box = std::min(p.box_rows, 256);   // a box dimension holds at most 256
  if (p.box_rows % p.tma_box != 0) return (int)cudaErrorInvalidValue;
  const int stages =
      float_scan_stages(T::kQT, TQ, T::kRows, (int)sizeof(ET), p.k, blocks_per_sm);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  p.n_stages = stages;
  const FloatSmem L = float_smem(T::kQT, TQ, T::kRows, (int)sizeof(ET), p.k, stages);
  const size_t row_bytes = (size_t)p.D * sizeof(ET);
  p.tma = row_bytes % 16 == 0 && p.D % 4 == 0 &&
          reinterpret_cast<uintptr_t>(p.emb) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(p.q) % 16 == 0;
  CUtensorMap emb_map, q_map;
  std::memset(&emb_map, 0, sizeof(emb_map));
  std::memset(&q_map, 0, sizeof(q_map));
  if (p.tma) {
    // the store as bytes [N, D * elt] in boxes of 128 bytes x tma_box rows
    const cuuint64_t e_dim[2] = {(cuuint64_t)row_bytes, (cuuint64_t)p.N};
    const cuuint64_t e_str[1] = {(cuuint64_t)row_bytes};
    const cuuint32_t e_box[2] = {(cuuint32_t)kChunk, (cuuint32_t)p.tma_box};
    const cuuint32_t ones[2] = {1, 1};
    CUresult r = cuTensorMapEncodeTiled(
        &emb_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p.emb), e_dim,
        e_str, e_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kTmaError + (int)r;
    // the queries [B, D] f32 in boxes of one D-chunk x the query tile,
    // zeros past B and D
    const cuuint64_t q_dim[2] = {(cuuint64_t)p.D, (cuuint64_t)p.B};
    const cuuint64_t q_str[1] = {(cuuint64_t)p.D * 4};
    const cuuint32_t q_box[2] = {(cuuint32_t)CE, (cuuint32_t)T::kQT};
    r = cuTensorMapEncodeTiled(
        &q_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p.q), q_dim, q_str,
        q_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kTmaError + (int)r;
  }
  auto kernel = scan_float<ET, TQ, QG, TR, kSelectMasked>;
  // The attributes (the largest request) are set once per instantiation and
  // device.  Two threads that race here both set the same values.
  static bool smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= kMaxDevices || !smem_set[device]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBlockMax);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    if (device < kMaxDevices) smem_set[device] = true;
  }
  kernel<<<n_chunks, kThreads, L.total, stream>>>(emb_map, q_map, p);
  return (int)cudaGetLastError();
}

// The tiles scan_float is built in, by query tile:
//   8 queries:  TQ 8 x 1 group, 2 rows a lane      (512-row tiles)
//   16:         TQ 8 x 2 groups, 2 rows            (256)
//   32:         TQ 16 x 2 groups, 2 rows           (256)
//   64:         TQ 16 x 4 groups, 4 rows           (256)
//   96:         TQ 12 x 8 groups, 4 rows           (128)
//   128:        TQ 16 x 8 groups, 4 rows           (128)
template <typename ET, bool kSelectMasked>
int launch_scan_float_as(const FloatParams& p, int query_tile, int n_chunks,
                         int blocks_per_sm, cudaStream_t s) {
  if (p.B > query_tile) return (int)cudaErrorInvalidValue;
  switch (query_tile) {
    case 8:
      return launch_scan_float_tile<ET, 8, 1, 2, kSelectMasked>(p, n_chunks, blocks_per_sm, s);
    case 16:
      return launch_scan_float_tile<ET, 8, 2, 2, kSelectMasked>(p, n_chunks, blocks_per_sm, s);
    case 32:
      return launch_scan_float_tile<ET, 16, 2, 2, kSelectMasked>(p, n_chunks, blocks_per_sm, s);
    case 64:
      return launch_scan_float_tile<ET, 16, 4, 4, kSelectMasked>(p, n_chunks, blocks_per_sm, s);
    case 96:
      return launch_scan_float_tile<ET, 12, 8, 4, kSelectMasked>(p, n_chunks, blocks_per_sm, s);
    case 128:
      return launch_scan_float_tile<ET, 16, 8, 4, kSelectMasked>(p, n_chunks, blocks_per_sm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool kSelectMasked>
int launch_scan_float(const FloatParams& p, bool bf16, int query_tile, int n_chunks,
                      int blocks_per_sm, cudaStream_t s) {
  return bf16 ? launch_scan_float_as<__nv_bfloat16, kSelectMasked>(p, query_tile, n_chunks,
                                                                   blocks_per_sm, s)
              : launch_scan_float_as<float, kSelectMasked>(p, query_tile, n_chunks,
                                                           blocks_per_sm, s);
}

// The planner's constants of scan_float, in the order of the Python
// planner's FLOAT_CONSTANTS.  Returns the count.
inline int float_scan_constants(int* out, int n) {
  const int c[] = {kThreads, kChunk, kFloatCandCap, kSeedBits, kScratch, kMaxStages,
                   kSmemBlockMax,
                   kSmemSM, kSmemReserved,
                   FloatTile<8, 1, 2>::kRows,
                   FloatTile<8, 2, 2>::kRows, FloatTile<16, 2, 2>::kRows,
                   FloatTile<16, 4, 4>::kRows, FloatTile<12, 8, 4>::kRows,
                   FloatTile<16, 8, 4>::kRows};
  const int m = (int)(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < n && i < m; ++i) out[i] = c[i];
  return m;
}

}  // namespace
