// K3: streaming score + carried per-query top-k for sm_90a.
//
// Replaces the TPU kernel rag_challenge_2_tpu/ops/pallas_topk_stream.py:145
// (stream_dense_topk -> _call, kernel _kernel): one program that streams
// the store from HBM through a hand-rolled double buffer (make_async_copy)
// and merges a tile into the running [B, k] top-k only when some score
// beats the current k-th (any_better).  It also computes what the JAX
// package's bounded-memory exact scan ops/topk.py:blocked_topk computes:
// f32 and bf16 stores, the int8 store with its per-row scales, the
// two-level (2-pass) int8 query, and the centroid-residual bias.
//
// What bounds it on the H100 (3.35 TB/s HBM, 1,979 dense int8 TOP/s on
// the tensor cores, ~33.5 T f32 FMA/s on the CUDA cores):
//   * int8, small batch (B <= 16 queries, or <= 8 in 2-pass; the hybrid's
//     routed slots): a call reads the N x D store once and does 2 B N D
//     int8 operations, <= 32 per store byte.  The read bounds it: 1.71 GB
//     of a 1.67M-row slot at D = 1024 takes 0.51 ms, the products 0.03 ms.
//   * int8, large batch (up to 128 queries, 256 code rows in 2-pass): 254
//     operations per store byte at B = 127, 508 in 2-pass.  A 10M x 1024
//     store takes 3.06 ms to read; the products 1.3 ms (2.6 ms in 2-pass)
//     at the tensor-core peak, so the read bounds it here too, closely.
//     What is left is the epilogue: B x N scores to test against the
//     queries' k-th values, ~1.3e9 at 10M rows.
//   * f32 (B up to 128): bound by the CUDA cores' IEEE f32 FMA rate (no
//     TF32): 130 G FMA at 1M x 1024, B = 127, ~3.9 ms at peak; below ~16
//     queries by the store read.  So was bf16, until the bf16_tc regime.
//   * bf16 above 16 queries (bf16_tc): the exact split of each f32 query
//     into three bf16 planes makes it three bf16 products on the tensor
//     cores: 3 x 2 B N D = 1.17 TFLOP at 1.5M x 1024, B = 127, 1.18 ms at
//     989 TFLOP/s, against 0.917 ms to read the 3.07 GB store.  Each stage
//     brings the query planes' D-chunk (3 x 128 queries x 128 bytes) beside
//     the store rows' (16 KB a 128-row tile), so the planes, re-read from L2
//     for every stage, are three times the bytes of one tile's rows.
//
// What the int8 design does about it (kernel scan_i8):
//   * products on the tensor cores: wgmma m64nNk32 s8 x s8 -> s32, with the
//     store rows on the M side (two warpgroups, 64 rows each of a 128-row
//     tile) and the query codes on the N side (N = the query tile), both
//     read by the tensor cores straight from the TMA-written shared memory
//     through descriptors.  A batch pads to the tile (16, 64, 128 or 256
//     code rows), not to a fixed 64-row query tile.  Sums are exact in int32
//     and the epilogue applies int8_scores in the JAX order with __fmul_rn /
//     __fadd_rn, so scores are bitwise equal to the plain version:
//     (acc * q_scale) * row_scale, or (acc_hi * s_hi + acc_lo * s_lo) *
//     row_scale, then + qc[b, assign[row]].
//   * a query tile sized to the batch, chosen by the wrapper: the small
//     regime keeps the whole code block [16, D] resident in shared memory
//     (<= 18 KB); the large regime stages the query's D-chunk beside each
//     128-row store tile.  Re-staging reads the small query block from L2,
//     never HBM (measured: it costs nothing at 10M rows).
//   * one HBM read of the store per call: a persistent grid of one (large)
//     or two (small) blocks per SM, each owning a contiguous row chunk for
//     all of the call's queries.  Stages arrive by TMA (a 2-D tensor map,
//     box 128 bytes x 128 rows, 128-byte swizzle: the layout wgmma reads)
//     into a ring of 2-8 stages sized to the shared memory left over,
//     completing on mbarriers; a tile's last slot is refilled before its
//     epilogue, so HBM keeps streaming while the scores are tested.  A
//     stage that has not arrived after 4 s traps (see mbar_wait).
//     A tile's row_scale, mask and assign are loaded once with the tile.
//     Rows that are not 16-byte aligned (D % 16 != 0, a misaligned view)
//     are loaded by the threads into the same swizzled layout.
//   * the gate in registers: each score is tested against its query's
//     current k-th value (a row that is masked carries a NaN scale and never
//     passes) in straight-line code that only notes the few that pass in a
//     4-entry per-thread scratch list; a short loop then takes them out of
//     line to the exact test under (value desc, row asc) and to a per-query
//     candidate list in shared memory (16 slots).  The epilogue's cost is
//     its code more than its arithmetic: an append written out at each of a
//     thread's 64 unrolled values was slower on the card than this.  The
//     lists are merged only when one is full (and once at the chunk's end):
//     the warp that owns a query rank-merges its list into the sorted
//     top-k, and the values that found no slot are retried.  After the
//     first tiles almost nothing passes.  The residual
//     bias is added to every score before its test, from qc transposed to
//     [n_codes, B] by the caller, so the four lanes that hold a row's
//     neighbouring queries share one 32-byte sector and the gathers of a
//     thread's values are independent loads.

// The f32 form, bf16 at up to 16 queries and stores TMA cannot read as
// bf16 boxes (D % 8 != 0, a base off 16 bytes) run scan_float
// (float_scan.cuh, shared with K1; its source note sets out the layout):
// the query tile picked from the batch (8 to 128 queries), 16 queries x 4
// rows of accumulators per thread at the large tiles (one shared-memory
// wavefront per 8-16 FMAs), one store read per call on a persistent grid,
// TMA stages, and the register gate with candidate lists.  The f32 form is
// bound by the f32 FMA rate of the CUDA cores above ~16 queries.
//
// The bf16 form above 16 queries runs scan_bf16_tc (regime bf16_tc):
//   * the split: a small kernel writes the queries as three bf16 planes
//     [3][query tile][D] (hi = bf16(q), mid = bf16(q - hi), lo = bf16(q -
//     hi - mid), zeros past B).  Both subtractions are exact in f32 and three
//     8-bit significands hold f32's 24, so hi + mid + lo == q for every q of
//     |q| >= 2^-110; a bf16 x bf16 product is exact in f32.  The planes
//     therefore sum the very products q_i r_i that scan_float forms with
//     FMA; only the order and rounding of the f32 sums differ.
//   * products: wgmma m64nNk16 bf16 x bf16 -> f32, store rows on the M side
//     (two warpgroups, 64 rows each of a 128-row tile), the query tile (32,
//     64, 96 or 128, the smallest that holds the batch) on the N side.  Per
//     128-byte D-chunk (64 values) the lo, mid and hi products go into a
//     fresh chunk sum (the smallest first), which is added to the row's f32
//     total with __fadd_rn, as scan_float adds its chunks: the tensor cores'
//     own rounding only ever acts on one chunk's partial sum.  The 128-query
//     tile sums a chunk in two halves of 64 queries, so that the chunk sum
//     and the totals of two tiles fit the registers (249 a thread).
//   * loads: a persistent grid of one block per SM, each owning a
//     contiguous row chunk for all queries (the store is read once), TMA
//     stages (128-byte swizzle: the layout wgmma reads) in a ring of 2-7 on
//     mbarriers.  A stage brings two 128-row tiles' D-chunk and the planes'
//     once for both, where a ring of two such stages fits the shared memory
//     (k <= 34 at 128 queries, every k below), else one tile's.  The last of
//     the 8 warps to finish a slot refills it (a counter per slot), so no
//     warp waits for a refill.
//   * what limits it: the planes, re-read from L2 for every stage.  With one
//     tile a stage and thread 0 refilling a slot after a block barrier, the
//     time per stage followed the bytes it brings, ~32 ns per KB a block at
//     every query tile (B = 17: 1.31 ms, 64: 1.76, 127: 2.88 ms over 1.5M
//     rows: 4.2 TB/s from L2 into the 132 SMs), not the ring's depth nor
//     the tensor cores.  Two tiles a stage cut the bytes a row by 37.5% at
//     128 queries and took B = 127 to 2.71 ms (B = 17: 1.14, 64: 1.59): the
//     tensor cores then run ~44% of each stage's time, the rest spent in
//     the four drains of each warpgroup's wgmma queue a stage (a second
//     chunk sum to overlap them would not fit the registers).  Clusters of
//     two blocks sharing each stage's planes by TMA multicast (a slot
//     refilled once both blocks freed it) measured slower: 3.88 ms at B =
//     127 with thread 0 refilling, 4.70 ms with a producer warp (B = 17:
//     2.60 / 2.84 ms); clusters of four fit 30 at once (120 of 132 SMs) and
//     took 9.65 ms.  So each block loads its own planes.  (All on NVIDIA
//     H100 80GB HBM3, 700 W.)
//   * the epilogue calls scan_float's offer_grouped (into per-query
//     candidate lists) and merge_warp_list (when one is full).  The first
//     tile's radix-select threshold (counts met by shuffles and shared
//     memory) and the register gate into a scratch list follow scan_float's
//     and scan_i8's, written a third time for wgmma's accumulator layout:
//     one helper over a value / row / query accessor for all three scans is
//     still to come.  A row's score does not depend on where it sits in a
//     tile or chunk, so copies of one row score the same bits and ties go
//     to the lowest row.
//
// Every block writes its k candidates per query; a second pass merges
// them under (value desc, row asc) in levels of 64 chunks, as K1's merge
// does.  Ties therefore go to the lowest row.  Masked rows never enter, so
// slots past the eligible rows keep row -1 and NEG_INF, as the Pallas
// kernel and blocked_topk return them.

#include <cstdio>

#include "float_scan.cuh"

namespace {

constexpr int kMergeGroup = 64;   // chunk lists merged per block and level

// ---- int8 (scan_i8)
constexpr int kI8Rows = 128;      // store rows per tile (the TMA box's rows)
constexpr int kSmallRows = 16;    // code rows of the small-batch regime
constexpr int kCandCap = 16;      // gated candidates buffered per query

// ============================================================ int8 path

// Rank-merge up to 32 candidates (one per lane) into the sorted list
// (tv, ti)[0, k): each entry and each candidate moves to the number of
// entries and candidates better than it; positions >= k drop out.
__device__ __forceinline__ void merge_candidates(float* tv, int* ti, int k,
                                                 const float* cv_s, const int* cr_s,
                                                 int n, int lane) {
  const bool c = lane < n;
  const float cv = c ? cv_s[lane] : kNegInf;
  const int cr = c ? cr_s[lane] : INT_MAX;
  const unsigned m = __ballot_sync(kFull, c);
  const float e0v = lane < k ? tv[lane] : kNegInf;
  const int e0r = lane < k ? ti[lane] : -1;
  const float e1v = lane + 32 < k ? tv[lane + 32] : kNegInf;
  const int e1r = lane + 32 < k ? ti[lane + 32] : -1;
  int pe0 = lane, pe1 = lane + 32, pc = 0;
  for (unsigned bits = m; bits != 0u; bits &= bits - 1) {
    const int t = __ffs(bits) - 1;
    const float yv = __shfl_sync(kFull, cv, t);
    const int yr = __shfl_sync(kFull, cr, t);
    pe0 += better(yv, yr, e0v, e0r);
    pe1 += better(yv, yr, e1v, e1r);
    pc += better(yv, yr, cv, cr);
  }
  if (c) pc += count_better(tv, ti, k, cv, cr);
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

// The exact test of a value that passed the gate's first test, and its
// append to query q's candidate list: compares with the k-th entry under
// (value desc, row asc).  Returns false when the list is full (the value
// is retried after the merge).  Kept out of line: few values get here,
// and the caller's accumulators stay in registers.
__device__ __noinline__ bool offer(float v, int row, int q, int k, const float* top_v,
                                   const int* top_i, int* cnt, float* cand_v, int* cand_r) {
  if (!better(v, row, top_v[q * k + k - 1], top_i[q * k + k - 1])) return true;
  const int slot = atomicAdd(cnt + q, 1);
  if (slot >= kCandCap) return false;
  cand_v[q * kCandCap + slot] = v;
  cand_r[q * kCandCap + slot] = row;
  return true;
}

// The query tile of kQN code rows: the small regime (kQN = 16) keeps the
// code block resident; the large one (kQN = 64/128/256) stages it per
// D-chunk.  Either way the 8 warps form two warpgroups, each running wgmma
// on 64 of the tile's 128 store rows against all kQN code rows.
template <int kQN>
struct I8Tile {
  static constexpr bool kSmall = kQN == kSmallRows;
  static constexpr int kNT = kQN / 8;   // n8 column tiles of the accumulator
  static constexpr int kBlocksPerSM = kSmall ? 2 : 1;
};

struct I8Params {
  const int8_t* q;          // [Bq, D] codes (2-pass: B hi rows, then B lo rows)
  const int8_t* emb;        // [N, D] codes
  const float* q_scale;     // [B] (s_hi in 2-pass)
  const float* q_scale_lo;  // [B] 2-pass: s_lo
  const float* row_scale;   // [N]
  const int* assign;        // [N] residual: centroid id per row, or null
  const float* qc_t;        // [n_codes, B] residual: (q . centroids^T)^T
  const uint8_t* mask;      // [N] row mask shared by all queries, or null
  int B;                    // logical queries
  int N;
  int D;
  int k;
  int rows_per_chunk;
  int n_stages;             // depth of the TMA ring
  int tma;                  // 1: stages arrive by TMA; 0: loaded by the threads
  float* cand_v;            // [B, n_chunks, k]
  int* cand_i;
};

// Byte offsets in the block's shared memory (after aligning it to 1024).
struct I8Smem {
  int stage;   // bytes of one ring stage: a store tile (+ the query chunk)
  int ring;
  int qres;    // small regime: the resident code block, [n_dch][16][128]
  int top_v, top_i, cand_v, cand_i, cnt;
  int meta_rs, meta_as;   // [2][kI8Rows] per tile, double-buffered
  int qs1, qs2;
  int scratch;
  int bar;
  int total;   // bytes to request, with the alignment slack
};

__host__ __device__ inline I8Smem i8_smem(int qn, bool two_pass, int D, int k,
                                          int n_stages) {
  const bool small = qn == kSmallRows;
  const int ql = two_pass ? qn / 2 : qn;
  I8Smem L;
  L.stage = kI8Rows * kChunk + (small ? 0 : qn * kChunk);
  L.ring = 0;
  int o = n_stages * L.stage;
  L.qres = o;
  if (small) o += (D + kChunk - 1) / kChunk * kSmallRows * kChunk;
  L.top_v = o;
  o += ql * k * 4;
  L.top_i = o;
  o += ql * k * 4;
  L.cand_v = o;
  o += ql * kCandCap * 4;
  L.cand_i = o;
  o += ql * kCandCap * 4;
  L.cnt = o;
  o += ql * 4;
  L.meta_rs = o;
  o += 2 * kI8Rows * 4;
  L.meta_as = o;
  o += 2 * kI8Rows * 4;
  L.qs1 = o;
  o += ql * 4;
  L.qs2 = o;
  o += ql * 4;
  o = round_up(o, 8);
  L.scratch = o;   // per thread: kScratch (value, bit) pairs of one gate pass
  o += kThreads * kScratch * 8;
  L.bar = o;
  o += kMaxStages * 8;
  L.total = o + 1024;
  return L;
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                       int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of a K-major [rows][128 bytes] block
// in TMA's 128-byte swizzle (1024-aligned): 8-row groups 1024 bytes apart.
// Adding 2 to it moves 32 bytes along K (the swizzle is applied to the
// address the hardware computes).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// shared memory written by the threads, made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x N] += A[64 x 32] . B[N x 32]^T, s8 x s8 -> s32, both operands
// K-major in shared memory; d[nt][e] is row g (+ 8 for e >= 2) of the
// warp's 16 and column 8 nt + 2 tg + (e & 1)
__device__ __forceinline__ void wgmma_n16(int (&d)[2][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[16][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[32][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]),
        "+r"(d[16][0]), "+r"(d[16][1]), "+r"(d[16][2]), "+r"(d[16][3]),
        "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]), "+r"(d[17][3]),
        "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]),
        "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3]),
        "+r"(d[20][0]), "+r"(d[20][1]), "+r"(d[20][2]), "+r"(d[20][3]),
        "+r"(d[21][0]), "+r"(d[21][1]), "+r"(d[21][2]), "+r"(d[21][3]),
        "+r"(d[22][0]), "+r"(d[22][1]), "+r"(d[22][2]), "+r"(d[22][3]),
        "+r"(d[23][0]), "+r"(d[23][1]), "+r"(d[23][2]), "+r"(d[23][3]),
        "+r"(d[24][0]), "+r"(d[24][1]), "+r"(d[24][2]), "+r"(d[24][3]),
        "+r"(d[25][0]), "+r"(d[25][1]), "+r"(d[25][2]), "+r"(d[25][3]),
        "+r"(d[26][0]), "+r"(d[26][1]), "+r"(d[26][2]), "+r"(d[26][3]),
        "+r"(d[27][0]), "+r"(d[27][1]), "+r"(d[27][2]), "+r"(d[27][3]),
        "+r"(d[28][0]), "+r"(d[28][1]), "+r"(d[28][2]), "+r"(d[28][3]),
        "+r"(d[29][0]), "+r"(d[29][1]), "+r"(d[29][2]), "+r"(d[29][3]),
        "+r"(d[30][0]), "+r"(d[30][1]), "+r"(d[30][2]), "+r"(d[30][3]),
        "+r"(d[31][0]), "+r"(d[31][1]), "+r"(d[31][2]), "+r"(d[31][3])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(int (&d)[N / 8][4], uint64_t a, uint64_t b) {
  if constexpr (N == 16) wgmma_n16(d, a, b);
  if constexpr (N == 64) wgmma_n64(d, a, b);
  if constexpr (N == 128) wgmma_n128(d, a, b);
  if constexpr (N == 256) wgmma_n256(d, a, b);
}

// D-chunk c of `rows` rows into `dst` in TMA's layout, by the threads:
// row_of(i) is the global row of block row i, or -1 for zeros; bytes past
// D are zeros.
template <typename RowOf>
__device__ void load_chunk_by_threads(unsigned char* dst, int rows, const int8_t* src,
                                      int D, int c, bool words, RowOf row_of) {
  for (int u = threadIdx.x; u < rows * (kChunk / 4); u += kThreads) {
    const int i = u / (kChunk / 4);
    const int w = u % (kChunk / 4);
    const long long r = row_of(i);
    const int d0 = c * kChunk + w * 4;
    uint32_t word = 0;
    if (r >= 0 && d0 < D) {
      const int8_t* s = src + r * D + d0;
      if (words && d0 + 4 <= D) {
        word = *reinterpret_cast<const uint32_t*>(s);
      } else {
        for (int j = 0; j < 4 && d0 + j < D; ++j)
          word |= (uint32_t)(uint8_t)s[j] << (8 * j);
      }
    }
    *reinterpret_cast<uint32_t*>(dst + i * kChunk + (((w >> 2) ^ (i & 7)) << 4) +
                                 (w & 3) * 4) = word;
  }
}

template <int kQN, bool kTwoPass>
__global__ void __launch_bounds__(kThreads, I8Tile<kQN>::kBlocksPerSM)
    scan_i8(const __grid_constant__ CUtensorMap emb_map,
            const __grid_constant__ CUtensorMap q_map, I8Params p) {
  using T = I8Tile<kQN>;
  constexpr int kNT = T::kNT;
  constexpr int kQL = kTwoPass ? kQN / 2 : kQN;     // logical queries of the tile
  constexpr int kNL = kTwoPass ? kNT / 2 : kNT;     // n8 tiles of logical queries
  constexpr int kValues = kNL * 2 * 2;              // epilogue values per thread
  static_assert(kValues <= 64, "one pending bit per epilogue value");

  // aligned to 1024 by an offset, not by integer arithmetic on the pointer,
  // so that the accesses keep the shared address space (LDS / STS)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const I8Smem L = i8_smem(kQN, kTwoPass, p.D, p.k, p.n_stages);
  float* top_v = reinterpret_cast<float*>(smem + L.top_v);
  int* top_i = reinterpret_cast<int*>(smem + L.top_i);
  float* cand_v = reinterpret_cast<float*>(smem + L.cand_v);
  int* cand_r = reinterpret_cast<int*>(smem + L.cand_i);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  float* m_rs = reinterpret_cast<float*>(smem + L.meta_rs);
  int* m_as = reinterpret_cast<int*>(smem + L.meta_as);
  float* qs1 = reinterpret_cast<float*>(smem + L.qs1);
  float* qs2 = reinterpret_cast<float*>(smem + L.qs2);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;    // accumulator row group
  const int tg = lane & 3;    // thread in the group
  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int r_begin = chunk * p.rows_per_chunk;
  const int r_end = min(p.N, r_begin + p.rows_per_chunk);
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + kI8Rows - 1) / kI8Rows : 0;
  const int n_dch = (p.D + kChunk - 1) / kChunk;
  const int total = n_tiles * n_dch;
  const int S = p.n_stages;
  const int k = p.k;
  const int B = p.B;
  const bool resid = p.assign != nullptr;
  const bool words = p.D % 4 == 0 && reinterpret_cast<uintptr_t>(p.emb) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(p.q) % 4 == 0;

  // block row i of the query tile -> global code row (hi rows first, then lo)
  auto q_row = [&](int i) -> long long {
    if constexpr (!kTwoPass) return i < B ? i : -1;
    const int half = kQN / 2;
    const int b = i < half ? i : i - half;
    return b < B ? (i < half ? b : B + b) : -1;
  };

  for (int i = tid; i < kQL * k; i += kThreads) {
    top_v[i] = kNegInf;
    top_i[i] = -1;
  }
  for (int i = tid; i < kQL; i += kThreads) {
    const bool ok = i < B;
    cnt[i] = 0;
    qs1[i] = ok ? p.q_scale[i] : 0.f;
    qs2[i] = ok && kTwoPass ? p.q_scale_lo[i] : 0.f;
  }
  if constexpr (T::kSmall) {
    for (int c = 0; c < n_dch; ++c)
      load_chunk_by_threads(smem + L.qres + c * kSmallRows * kChunk, kSmallRows, p.q,
                            p.D, c, words, q_row);
    fence_proxy_async();  // the threads' writes, visible to wgmma
  }
  if (p.tma && tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(bars + s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage s = (tile s / n_dch, D-chunk s % n_dch) into ring slot s % S:
  // the store tile's D-chunk and (large regime) the query's
  auto issue = [&](int s) {
    unsigned char* st = smem + L.ring + (s % S) * L.stage;
    const uint32_t bar = smem_u32(bars + s % S);
    const int c = s % n_dch;
    mbar_expect_tx(bar, L.stage);
    tma_2d(smem_u32(st), &emb_map, c * kChunk, r_begin + (s / n_dch) * kI8Rows, bar);
    if constexpr (!T::kSmall)
      tma_3d(smem_u32(st + kI8Rows * kChunk), &q_map, c * kChunk, 0, 0, bar);
  };
  if (p.tma && tid == 0) {
    for (int s = 0; s < S && s < total; ++s) issue(s);
  }

  // every query's buffered candidates into its sorted top-k (one warp per
  // query), buffers emptied
  auto merge_all = [&]() {
    for (int q = warp; q < kQL; q += kWarps) {
      const int n = cnt[q];
      if (n == 0) continue;
      merge_candidates(top_v + q * k, top_i + q * k, k, cand_v + q * kCandCap,
                       cand_r + q * kCandCap, min(n, kCandCap), lane);
      if (lane == 0) cnt[q] = 0;
    }
  };

  // this thread's accumulator rows: warp w holds tile rows 16 w + g (+ 8)
  // (warpgroup w / 4 computes rows 64 (w / 4) .. + 63)
  const int lr0 = warp * 16 + g;
  int acc[kNT][4];
  for (int s = 0; s < total; ++s) {
    const int c = s % n_dch;
    const int t = s / n_dch;
    const int slot = s % S;
    const int row0 = r_begin + t * kI8Rows;
    unsigned char* st = smem + L.ring + slot * L.stage;
    unsigned char* qt = T::kSmall ? smem + L.qres + c * kSmallRows * kChunk
                                  : st + kI8Rows * kChunk;
    if (c == 0) {
      // the tile's row metadata, read by the epilogue after its barrier;
      // a row that is masked or past the chunk gets a NaN scale, so its
      // scores fail every comparison
      if (tid < kI8Rows) {
        const int row = row0 + tid;
        const bool ok = row < r_end && (p.mask == nullptr || p.mask[row] != 0);
        m_rs[(t & 1) * kI8Rows + tid] = ok ? p.row_scale[row] : __int_as_float(0x7fffffff);
        m_as[(t & 1) * kI8Rows + tid] = ok && resid ? p.assign[row] : 0;
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
    }
    if (p.tma) {
      mbar_wait(smem_u32(bars + slot), (s / S) & 1);
    } else {
      const int N = p.N;
      load_chunk_by_threads(st, kI8Rows, p.emb, p.D, c, words, [&](int i) -> long long {
        return row0 + i < N ? (long long)(row0 + i) : -1;
      });
      if constexpr (!T::kSmall)
        load_chunk_by_threads(qt, kQN, p.q, p.D, c, words, q_row);
      fence_proxy_async();
      __syncthreads();
    }

    // ---- products: 4 wgmma k-steps of 32 bytes over the 128-byte chunk,
    // the warpgroup's 64 store rows against all kQN code rows
    {
      const uint64_t da = smem_desc(st + (warp / 4) * 64 * kChunk);
      const uint64_t db = smem_desc(qt);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kChunk / 32; ++j) wgmma<kQN>(acc, da + 2 * j, db + 2 * j);
      wgmma_commit();
      wgmma_wait_all();
    }
    // the slot is free once every warp's products are done (the scores are
    // in registers), so it is refilled before the epilogue runs; the
    // barrier also makes the tile's metadata visible
    __syncthreads();
    if (p.tma && tid == 0 && s + S < total) issue(s + S);

    if (c == n_dch - 1) {
      // ---- epilogue: gate each value in registers against its query's
      // k-th entry; the ones that beat it go to the query's candidate
      // list, which is merged only once some list is full
      float rs[2];
      int as[2];
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
        rs[r8] = m_rs[(t & 1) * kI8Rows + lr0 + 8 * r8];
        as[r8] = m_as[(t & 1) * kI8Rows + lr0 + 8 * r8];
      }
      // this thread's scratch list: the (score, value bit) pairs of a pass
      float* sv = reinterpret_cast<float*>(smem + L.scratch) + tid * kScratch;
      int* sb = reinterpret_cast<int*>(smem + L.scratch + kThreads * kScratch * 4) +
                tid * kScratch;
      // the values in `todo`, through as many passes of this thread as its
      // scratch list needs: a value goes on only if its score (with its
      // residual bias) is >= its query's k-th value (better() implies it;
      // NaN never passes).  Returns the values whose candidate list was full
      auto gate = [&](uint64_t todo) -> uint64_t {
        uint64_t full = 0;
        while (todo != 0ull) {
          uint64_t later = 0;
          int n = 0;
#pragma unroll
          for (int j = 0; j < kNL; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int base = (j * 2 + e) * 2;
              if (((todo >> base) & 3ull) == 0) continue;
              const int q = j * 8 + tg * 2 + e;
              const float kv = top_v[q * k + k - 1];
              const float s1 = qs1[q];
              const float s2 = qs2[q];
#pragma unroll
              for (int r8 = 0; r8 < 2; ++r8) {
                const int ci = r8 * 2 + e;
                float v;
                if constexpr (kTwoPass) {
                  v = __fmul_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc[j][ci]), s1),
                                          __fmul_rn(__int2float_rn(acc[j + kNL][ci]), s2)),
                                rs[r8]);
                } else {
                  v = __fmul_rn(__fmul_rn(__int2float_rn(acc[j][ci]), s1), rs[r8]);
                }
                if (resid) v = __fadd_rn(v, p.qc_t[(size_t)as[r8] * B + q]);
                if (((todo >> (base + r8)) & 1ull) && v >= kv) {
                  if (n < kScratch) {
                    sv[n] = v;
                    sb[n] = base + r8;
                    ++n;
                  } else {
                    later |= 1ull << (base + r8);   // no scratch slot: next pass
                  }
                }
              }
            }
          // the noted values, in a rolled loop: one call site
          for (int i = 0; i < n; ++i) {
            const int bit = sb[i];
            const int q = (bit >> 2) * 8 + tg * 2 + ((bit >> 1) & 1);
            const int r8 = bit & 1;
            if (!offer(sv[i], row0 + lr0 + 8 * r8, q, k, top_v, top_i, cnt, cand_v, cand_r))
              full |= 1ull << bit;
          }
          todo = later;
        }
        return full;
      };
      // values of queries past B are never candidates
      uint64_t todo = 0;
#pragma unroll
      for (int j = 0; j < kNL; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * 8 + tg * 2 + e < B) todo |= 3ull << ((j * 2 + e) * 2);
      while (true) {
        todo = gate(todo);
        if (!__syncthreads_or(todo != 0ull)) break;
        merge_all();  // every list: fresh k-th values let fewer values through
        __syncthreads();
      }
    }
  }
  merge_all();
  __syncthreads();

  for (int q = warp; q < kQL && q < B; q += kWarps) {
    for (int j = lane; j < k; j += 32) {
      const size_t o = ((size_t)q * n_chunks + chunk) * k + j;
      p.cand_v[o] = top_v[q * k + j];
      p.cand_i[o] = top_i[q * k + j];
    }
  }
}

// One merge level: block (g, b) stages the candidate lists of chunks
// [g * kMergeGroup, (g + 1) * kMergeGroup) of query b in shared memory
// and selects their top-k into out[b][g] by k rounds of "best entry
// strictly after the last one taken".  Once only (NEG_INF, -1) fillers
// are left, the remaining slots are fillers too.
__global__ void __launch_bounds__(kThreads)
    merge_groups(const float* __restrict__ in_v, const int* __restrict__ in_i,
                 int n, int k, float* __restrict__ out_v,
                 int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char msmem[];
  float* sv = reinterpret_cast<float*>(msmem);  // [kMergeGroup * k]
  int* si = reinterpret_cast<int*>(sv + kMergeGroup * k);
  __shared__ float red_v[kWarps];
  __shared__ int red_r[kWarps];
  __shared__ float sel_v;
  __shared__ int sel_r;
  const int g = blockIdx.x;
  const int groups = gridDim.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t0 = g * kMergeGroup;
  const int C = min(kMergeGroup, n - t0) * k;
  const size_t src = ((size_t)b * n + t0) * k;
  for (int i = threadIdx.x; i < C; i += kThreads) {
    sv[i] = in_v[src + i];
    si[i] = in_i[src + i];
  }
  __syncthreads();
  const size_t dst = ((size_t)b * groups + g) * k;
  float pv = 0.f;
  int pr = 0;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int br = INT_MAX;
    for (int i = threadIdx.x; i < C; i += kThreads) {
      const float v = sv[i];
      const int r = si[i];
      if ((j == 0 || better(pv, pr, v, r)) && better(v, r, bv, br)) {
        bv = v;
        br = r;
      }
    }
    warp_best(bv, br);
    if (lane == 0) {
      red_v[warp] = bv;
      red_r[warp] = br;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -INFINITY;
      br = lane < kWarps ? red_r[lane] : INT_MAX;
      warp_best(bv, br);
      if (lane == 0) {
        sel_v = bv;
        sel_r = br;
        const bool none = br == INT_MAX;
        out_v[dst + j] = none ? kNegInf : bv;
        out_i[dst + j] = none ? -1 : br;
      }
    }
    __syncthreads();
    pv = sel_v;
    pr = sel_r;
  }
}

int merge_groups_of(int n) { return (n + kMergeGroup - 1) / kMergeGroup; }

// The chunks' [B, n_chunks, k] lists into [B, k]: merge levels ping-pong
// between the scratch tail (after the candidates) and the candidate area.
cudaError_t merge_levels(float* cand_v, int* cand_i, int B, int n_chunks, int k,
                         float* out_v, int* out_i, cudaStream_t stream) {
  float* tmp_v = cand_v + (size_t)B * n_chunks * k;
  int* tmp_i = cand_i + (size_t)B * n_chunks * k;
  const float* in_v = cand_v;
  const int* in_i = cand_i;
  const size_t msmem = (size_t)kMergeGroup * k * (sizeof(float) + sizeof(int));
  for (int n = n_chunks, level = 0;; ++level) {
    const int groups = merge_groups_of(n);
    float* o_v = groups == 1 ? out_v : (level % 2 == 0 ? tmp_v : cand_v);
    int* o_i = groups == 1 ? out_i : (level % 2 == 0 ? tmp_i : cand_i);
    merge_groups<<<dim3(groups, B), kThreads, msmem, stream>>>(in_v, in_i, n, k, o_v, o_i);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || groups == 1) return e;
    in_v = o_v;
    in_i = o_i;
    n = groups;
  }
}

template <int kQN, bool kTwoPass>
int launch_i8(I8Params p, int n_chunks, float* out_v, int* out_i, cudaStream_t stream) {
  using T = I8Tile<kQN>;
  const int budget = T::kBlocksPerSM == 1 ? kSmemBlockMax
                                          : kSmemSM / T::kBlocksPerSM - kSmemReserved;
  const I8Smem L0 = i8_smem(kQN, kTwoPass, p.D, p.k, 0);
  const int stages = std::min(kMaxStages, (budget - L0.total) / L0.stage);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  p.n_stages = stages;
  const I8Smem L = i8_smem(kQN, kTwoPass, p.D, p.k, stages);
  p.tma = p.D % 16 == 0 && reinterpret_cast<uintptr_t>(p.emb) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(p.q) % 16 == 0;
  CUtensorMap emb_map, q_map;
  std::memset(&emb_map, 0, sizeof(emb_map));
  std::memset(&q_map, 0, sizeof(q_map));
  if (p.tma) {
    // the store [N, D] in boxes of 128 bytes x 128 rows
    const cuuint64_t e_dim[2] = {(cuuint64_t)p.D, (cuuint64_t)p.N};
    const cuuint64_t e_str[1] = {(cuuint64_t)p.D};
    const cuuint32_t e_box[2] = {(cuuint32_t)kChunk, (cuuint32_t)kI8Rows};
    const cuuint32_t ones[3] = {1, 1, 1};
    CUresult r = cuTensorMapEncodeTiled(
        &emb_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p.emb), e_dim,
        e_str, e_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kTmaError + (int)r;
    if (!T::kSmall) {
      // the codes as [P][B][D] (P = 2 in 2-pass: hi, lo), in boxes of 128
      // bytes x kQN / P rows x P: hi rows, then lo rows, zeros past B
      const int P = kTwoPass ? 2 : 1;
      const cuuint64_t q_dim[3] = {(cuuint64_t)p.D, (cuuint64_t)p.B, (cuuint64_t)P};
      const cuuint64_t q_str[2] = {(cuuint64_t)p.D, (cuuint64_t)p.B * p.D};
      const cuuint32_t q_box[3] = {(cuuint32_t)kChunk, (cuuint32_t)(kQN / P), (cuuint32_t)P};
      r = cuTensorMapEncodeTiled(
          &q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(p.q), q_dim, q_str,
          q_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return kTmaError + (int)r;
    }
  }
  auto kernel = scan_i8<kQN, kTwoPass>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_chunks, kThreads, L.total, stream>>>(emb_map, q_map, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)merge_levels(p.cand_v, p.cand_i, p.B, n_chunks, p.k, out_v, out_i, stream);
}

template <bool kTwoPass>
int launch_i8_tile(int qn, const I8Params& p, int n_chunks, float* ov, int* oi,
                   cudaStream_t s) {
  switch (qn) {
    case kSmallRows: return launch_i8<kSmallRows, kTwoPass>(p, n_chunks, ov, oi, s);
    case 64: return launch_i8<64, kTwoPass>(p, n_chunks, ov, oi, s);
    case 128: return launch_i8<128, kTwoPass>(p, n_chunks, ov, oi, s);
    case 256:
      if constexpr (kTwoPass) return launch_i8<256, true>(p, n_chunks, ov, oi, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// ============================================================ bf16 path

// ---- bf16_tc (scan_bf16_tc)
constexpr int kTcRows = 128;       // store rows per tile (two warpgroups x 64)
constexpr int kTcCandCap = 16;     // gated candidates buffered per query
constexpr int kTcMinQueries = 17;  // the regime's smallest batch (below: scan_float)
constexpr int kPlanes = 3;         // bf16 planes of an f32 query: hi, mid, lo
constexpr int kTcChunkElems = kChunk / 2;   // bf16 values per D-chunk

// f32 queries [B, D] into three bf16 planes [3][qn][D] (hi, mid, lo), zeros
// past B.  hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid): each
// subtraction is exact in f32 (its operands agree in their leading bits),
// and three 8-bit significands hold f32's 24, so hi + mid + lo == x for
// every x of |x| >= 2^-110 (below it lo falls under bf16's least subnormal
// and rounds; see ops/stream_topk.split_bf16x3).
__global__ void __launch_bounds__(kThreads)
    split_bf16x3(const float* __restrict__ q, int B, int D, int qn,
                 __nv_bfloat16* __restrict__ planes) {
  const int n = qn * D;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const float x = i < B * D ? q[i] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float r = __fsub_rn(x, __bfloat162float(hi));
    const __nv_bfloat16 mid = __float2bfloat16_rn(r);
    planes[i] = hi;
    planes[n + i] = mid;
    planes[2 * n + i] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
  }
}

// d[64 x N] (+)= A[64 x 16] . B[N x 16]^T, bf16 x bf16 -> f32, both operands
// K-major in shared memory; scale_d 0 starts a fresh sum.  d[nt][e] is row
// g (+ 8 for e >= 2) of the warp's 16 and column 8 nt + 2 tg + (e & 1), as
// in the int8 forms.
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[4][4], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[8][4], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n96(float (&d)[12][4], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                                           int scale_d) {
  if constexpr (N == 32) wgmma_bf16_n32(d, a, b, scale_d);
  if constexpr (N == 64) wgmma_bf16_n64(d, a, b, scale_d);
  if constexpr (N == 96) wgmma_bf16_n96(d, a, b, scale_d);
}

struct TcParams {
  const __nv_bfloat16* emb;  // [N, D] bf16 rows
  const uint8_t* mask;       // [N] row mask shared by all queries, or null
  int B;
  int N;
  int D;
  int k;
  int rows_per_chunk;
  int n_stages;              // depth of the TMA ring
  float* cand_v;             // [B, n_chunks, k]
  int* cand_i;
};

// Byte offsets in the block's shared memory (after aligning it to 1024).
struct TcSmem {
  int stage;   // bytes of one ring stage: the row tiles' D-chunk + the planes'
  int top_v, top_i, cand_v, cand_i, cnt, thr, pre, rcnt, meta, scratch, freed, bar;
  int total;   // bytes to request, with the alignment slack
};

// `tiles`: row tiles a stage brings (1 or 2), sharing the stage's planes.
__host__ __device__ inline TcSmem tc_smem(int qn, int tiles, int k, int n_stages) {
  TcSmem L;
  L.stage = tiles * kTcRows * kChunk + kPlanes * qn * kChunk;
  int o = n_stages * L.stage;
  L.top_v = o;
  o += qn * k * 4;
  L.top_i = o;
  o += qn * k * 4;
  L.cand_v = o;
  o += qn * kTcCandCap * 4;
  L.cand_i = o;
  o += qn * kTcCandCap * 4;
  L.cnt = o;
  o += qn * 4;
  L.thr = o;    // [qn] the first tile's threshold per query
  o += qn * 4;
  L.pre = o;    // [qn] its order key, bit by bit
  o += qn * 4;
  L.rcnt = o;   // [kWarps][qn] each warp's count of one bit step
  o += kWarps * qn * 4;
  L.freed = o;  // [kMaxStages] warps done with the slot's current stage
  o += kMaxStages * 4;
  L.meta = o;   // [2][tiles * kTcRows] 1 = a candidate row, per stage's tiles
  o += 2 * tiles * kTcRows;
  o = round_up(o, 8);
  L.scratch = o;   // per thread: kScratch (value, bit) pairs of one gate pass
  o += kThreads * kScratch * 8;
  L.bar = o;
  o += kMaxStages * 8;
  L.total = o + 1024;
  return L;
}

inline int tc_stages(int qn, int tiles, int k) {
  const TcSmem L0 = tc_smem(qn, tiles, k, 0);
  return std::max(0, std::min(kMaxStages, (kSmemBlockMax - L0.total) / L0.stage));
}

// kTiles row tiles of 128 a stage (two where a ring of two such stages
// fits: the planes' bytes then serve 256 rows), each scored by both
// warpgroups in turn against the stage's planes.
template <int kQN, int kTiles>
__global__ void __launch_bounds__(kThreads, 1)
    scan_bf16_tc(const __grid_constant__ CUtensorMap emb_map,
                 const __grid_constant__ CUtensorMap q_map, TcParams p) {
  constexpr int kNT = kQN / 8;   // n8 column tiles of a tile's totals
  // a 128-query tile sums a chunk in two halves of 64 queries, so that the
  // chunk sum and the totals fit the registers
  constexpr int kHalves = kQN == 128 ? 2 : 1;
  constexpr int kQH = kQN / kHalves;   // queries of one half
  constexpr int kNH = kNT / kHalves;   // its n8 column tiles
  constexpr int kRows = kTiles * kTcRows;   // store rows of a stage
  static_assert(kNT * 4 <= 64, "one pending bit per epilogue value");

  // aligned to 1024 by an offset, not by integer arithmetic on the pointer,
  // so that the accesses keep the shared address space (LDS / STS)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int k = p.k;
  const int S = p.n_stages;
  const TcSmem L = tc_smem(kQN, kTiles, k, S);
  float* top_v = reinterpret_cast<float*>(smem + L.top_v);
  int* top_i = reinterpret_cast<int*>(smem + L.top_i);
  float* cand_v = reinterpret_cast<float*>(smem + L.cand_v);
  int* cand_r = reinterpret_cast<int*>(smem + L.cand_i);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  float* thr = reinterpret_cast<float*>(smem + L.thr);
  uint32_t* pre = reinterpret_cast<uint32_t*>(smem + L.pre);
  int* rcnt = reinterpret_cast<int*>(smem + L.rcnt);
  int* freed = reinterpret_cast<int*>(smem + L.freed);
  unsigned char* meta = smem + L.meta;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;    // accumulator row group
  const int tg = lane & 3;    // thread in the group
  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int r_begin = chunk * p.rows_per_chunk;
  const int r_end = min(p.N, r_begin + p.rows_per_chunk);
  const int n_groups = r_end > r_begin ? (r_end - r_begin + kRows - 1) / kRows : 0;
  const int n_dch = (p.D + kTcChunkElems - 1) / kTcChunkElems;
  const int total = n_groups * n_dch;
  const int B = p.B;

  for (int i = tid; i < kQN * k; i += kThreads) {
    top_v[i] = kNegInf;
    top_i[i] = -1;
  }
  for (int i = tid; i < kQN; i += kThreads) {
    cnt[i] = 0;
    thr[i] = -INFINITY;
    pre[i] = 0u;
  }
  if (tid < kMaxStages) freed[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(bars + s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage s = (tile group s / n_dch, D-chunk s % n_dch) into ring slot s % S:
  // the row tiles' D-chunk, then the three planes' [3][kQN][128 bytes]
  auto issue = [&](int s) {
    unsigned char* st = smem + (s % S) * L.stage;
    const uint32_t bar = smem_u32(bars + s % S);
    const int c = s % n_dch;
    mbar_expect_tx(bar, L.stage);
    tma_2d(smem_u32(st), &emb_map, c * kTcChunkElems, r_begin + (s / n_dch) * kRows, bar);
    tma_3d(smem_u32(st + kRows * kChunk), &q_map, c * kTcChunkElems, 0, 0, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < S && s < total; ++s) issue(s);
  }

  // every query's buffered candidates into its sorted top-k (one warp per
  // query), buffers emptied
  auto merge_all = [&]() {
    for (int q = warp; q < kQN; q += kWarps) {
      const int n = cnt[q];
      if (n == 0) continue;
      merge_warp_list(top_v + q * k, top_i + q * k, k, cand_v + q * kTcCandCap,
                      cand_r + q * kTcCandCap, min(n, kTcCandCap), lane);
      if (lane == 0) cnt[q] = 0;
    }
  };

  // ---- the epilogue of one tile (first: the block's first tile), its
  // totals `tv` in registers: value nt * 4 + e is query 8 nt + 2 tg +
  // (e & 1) at tile row lr0 + 8 (e >> 1)
  const int lr0 = warp * 16 + g;
  auto epilogue = [&](float (&tv)[kNT][4], const unsigned char* codes, int row0, bool first) {
    int code[2];
#pragma unroll
    for (int r8 = 0; r8 < 2; ++r8) code[r8] = codes[lr0 + 8 * r8];
    if (first) {
      // The chunk's first tile meets empty lists.  Its threshold per query
      // is the radix select of scan_float: the k-th largest value's order
      // key bit by bit from the top, cut after kSeedBits bits (so it lies
      // at or below the k-th value).  A query's values of one warp sit on
      // the 8 lanes of one tg: their counts meet by shuffles, the warps'
      // through shared memory.
      for (int b = 0; b < kSeedBits; ++b) {
        const uint32_t bit = 0x80000000u >> b;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int q = nt * 8 + tg * 2 + e1;
            const uint32_t want = pre[q] | bit;
            int c_q = 0;
#pragma unroll
            for (int r8 = 0; r8 < 2; ++r8)
              c_q += code[r8] != 0 && order_key(tv[nt][r8 * 2 + e1]) >= want;
            c_q += __shfl_xor_sync(kFull, c_q, 4);
            c_q += __shfl_xor_sync(kFull, c_q, 8);
            c_q += __shfl_xor_sync(kFull, c_q, 16);
            if (g == 0) rcnt[warp * kQN + q] = c_q;
          }
        __syncthreads();
        if (tid < kQN) {
          int n_q = 0;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) n_q += rcnt[w * kQN + tid];
          if (n_q >= k) pre[tid] |= bit;
        }
        __syncthreads();
      }
      if (tid < kQN && pre[tid] != 0u) {
        const float t0 = key_value(pre[tid]);
        if (t0 == t0) thr[tid] = t0;   // not a NaN pattern
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
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            if (((todo >> (nt * 4 + e1)) & 5ull) == 0) continue;   // both rows done
            const int q = nt * 8 + tg * 2 + e1;
            const float kv = fmaxf(top_v[q * k + k - 1], thr[q]);
#pragma unroll
            for (int r8 = 0; r8 < 2; ++r8) {
              const int bit = nt * 4 + r8 * 2 + e1;
              const float v = tv[nt][r8 * 2 + e1];
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
          if (!offer_grouped(sv[m], row0 + lr0 + 8 * ((bit >> 1) & 1),
                             (bit >> 2) * 8 + tg * 2 + (bit & 1), k, top_v, top_i, cnt,
                             cand_v, cand_r, kTcCandCap))
            full |= 1ull << bit;
        }
        todo = later;
      }
      return full;
    };
    // rows that are no candidates and queries past B never enter
    uint64_t todo = 0;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (nt * 8 + tg * 2 + (e & 1) < B && code[e >> 1] != 0) todo |= 1ull << (nt * 4 + e);
    while (true) {
      todo = gate(todo);
      if (!__syncthreads_or(todo != 0ull)) break;
      merge_all();  // every list: fresh k-th values let fewer values through
      __syncthreads();
    }
  };

  float tot[kTiles][kNT][4];   // the tiles' scores over the D-chunks so far
  float acc[kNH][4];           // one D-chunk's sum for one tile and half
#pragma unroll
  for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int s = 0; s < total; ++s) {
    const int c = s % n_dch;
    const int grp = s / n_dch;
    const int slot = s % S;
    const int row0 = r_begin + grp * kRows;
    unsigned char* st = smem + slot * L.stage;
    if (c == 0) {
      // the stage's rows, read by the epilogue after its barrier: 1 for a
      // row of the chunk that the mask keeps
      for (int i = tid; i < kRows; i += kThreads) {
        const int row = row0 + i;
        meta[(grp & 1) * kRows + i] =
            row < r_end && (p.mask == nullptr || p.mask[row] != 0) ? 1 : 0;
      }
#pragma unroll
      for (int tt = 0; tt < kTiles; ++tt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[tt][nt][e] = 0.f;
    }
    mbar_wait(smem_u32(bars + slot), (s / S) & 1);

    // ---- products: for each tile and half of the queries, the chunk's sum
    // of lo, mid and hi (the smallest first), 4 k-steps of 16 bf16 each, the
    // warpgroup's 64 rows of the tile; the tensor cores round only this
    // partial sum, which is then added to the row's total in IEEE f32, as
    // scan_float adds its chunks
#pragma unroll
    for (int tt = 0; tt < kTiles; ++tt) {
      const uint64_t da = smem_desc(st + (tt * kTcRows + (warp / 4) * 64) * kChunk);
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        wgmma_fence();
#pragma unroll
        for (int pl = kPlanes - 1; pl >= 0; --pl) {
          const uint64_t db =
              smem_desc(st + kRows * kChunk + (pl * kQN + h * kQH) * kChunk);
#pragma unroll
          for (int j = 0; j < kChunk / 32; ++j)
            wgmma_bf16<kQH>(acc, da + 2 * j, db + 2 * j, pl == kPlanes - 1 && j == 0 ? 0 : 1);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tot[tt][h * kNH + nt][e] = __fadd_rn(tot[tt][h * kNH + nt][e], acc[nt][e]);
      }
    }
    // this warp is done with the slot; the last of the 8 warps to be done
    // refills it, so no warp waits for a refill
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(freed + slot, 1) == kWarps - 1) {
        freed[slot] = 0;
        __threadfence_block();
        if (s + S < total) issue(s + S);
      }
    }
    if (c != n_dch - 1) continue;

    __syncthreads();   // the stage's row codes
#pragma unroll
    for (int tt = 0; tt < kTiles; ++tt)
      epilogue(tot[tt], meta + (grp & 1) * kRows + tt * kTcRows, row0 + tt * kTcRows,
               grp == 0 && tt == 0);
  }
  merge_all();
  __syncthreads();

  for (int q = warp; q < kQN && q < B; q += kWarps) {
    for (int j = lane; j < k; j += 32) {
      const size_t o = ((size_t)q * n_chunks + chunk) * k + j;
      p.cand_v[o] = top_v[q * k + j];
      p.cand_i[o] = top_i[q * k + j];
    }
  }
}

template <int kQN, int kTiles>
int launch_bf16_tc(TcParams p, const float* q, __nv_bfloat16* planes, int n_chunks,
                   float* out_v, int* out_i, cudaStream_t stream) {
  if (p.B > kQN || p.D % 8 != 0 || reinterpret_cast<uintptr_t>(p.emb) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(planes) % 16 != 0 || p.rows_per_chunk % (kTiles * kTcRows))
    return (int)cudaErrorInvalidValue;
  const int stages = tc_stages(kQN, kTiles, p.k);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  p.n_stages = stages;
  const TcSmem L = tc_smem(kQN, kTiles, p.k, stages);
  const int n = kQN * p.D;
  split_bf16x3<<<std::min((n + kThreads - 1) / kThreads, 1024), kThreads, 0, stream>>>(
      q, p.B, p.D, kQN, planes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap emb_map, q_map;
  std::memset(&emb_map, 0, sizeof(emb_map));
  std::memset(&q_map, 0, sizeof(q_map));
  const cuuint32_t ones[3] = {1, 1, 1};
  // the store [N, D] in boxes of 64 values (128 bytes) x the stage's rows,
  // zeros past N and D
  const cuuint64_t e_dim[2] = {(cuuint64_t)p.D, (cuuint64_t)p.N};
  const cuuint64_t e_str[1] = {(cuuint64_t)p.D * 2};
  const cuuint32_t e_box[2] = {(cuuint32_t)kTcChunkElems, (cuuint32_t)(kTiles * kTcRows)};
  CUresult r = cuTensorMapEncodeTiled(
      &emb_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<__nv_bfloat16*>(p.emb), e_dim, e_str, e_box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kTmaError + (int)r;
  // the planes [3][kQN][D] in boxes of 64 values x kQN x 3
  const cuuint64_t q_dim[3] = {(cuuint64_t)p.D, (cuuint64_t)kQN, (cuuint64_t)kPlanes};
  const cuuint64_t q_str[2] = {(cuuint64_t)p.D * 2, (cuuint64_t)kQN * p.D * 2};
  const cuuint32_t q_box[3] = {(cuuint32_t)kTcChunkElems, (cuuint32_t)kQN,
                               (cuuint32_t)kPlanes};
  r = cuTensorMapEncodeTiled(
      &q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, planes, q_dim, q_str, q_box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kTmaError + (int)r;
  auto kernel = scan_bf16_tc<kQN, kTiles>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_chunks, kThreads, L.total, stream>>>(emb_map, q_map, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)merge_levels(p.cand_v, p.cand_i, p.B, n_chunks, p.k, out_v, out_i, stream);
}

// `tiles`: row tiles a stage brings, 1 or 2 (the planner's choice).
int launch_bf16_tc_tile(int qn, int tiles, const TcParams& p, const float* q,
                        __nv_bfloat16* planes, int n_chunks, float* ov, int* oi,
                        cudaStream_t s) {
  switch (qn * 4 + tiles) {
    case 32 * 4 + 1: return launch_bf16_tc<32, 1>(p, q, planes, n_chunks, ov, oi, s);
    case 32 * 4 + 2: return launch_bf16_tc<32, 2>(p, q, planes, n_chunks, ov, oi, s);
    case 64 * 4 + 1: return launch_bf16_tc<64, 1>(p, q, planes, n_chunks, ov, oi, s);
    case 64 * 4 + 2: return launch_bf16_tc<64, 2>(p, q, planes, n_chunks, ov, oi, s);
    case 96 * 4 + 1: return launch_bf16_tc<96, 1>(p, q, planes, n_chunks, ov, oi, s);
    case 96 * 4 + 2: return launch_bf16_tc<96, 2>(p, q, planes, n_chunks, ov, oi, s);
    case 128 * 4 + 1: return launch_bf16_tc<128, 1>(p, q, planes, n_chunks, ov, oi, s);
    case 128 * 4 + 2: return launch_bf16_tc<128, 2>(p, q, planes, n_chunks, ov, oi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The planner's constants, in this order: int8 store rows per tile, the
// small regime's code rows, its blocks per SM, the large regime's blocks
// per SM, its three query tiles; candidate slots per query; then
// scan_float's (float_scan_constants).  Returns the count.
int rc2_stream_topk_constants(int* out, int n) {
  const int c[] = {kI8Rows, kSmallRows, I8Tile<kSmallRows>::kBlocksPerSM,
                   I8Tile<128>::kBlocksPerSM, 64, 128, 256, kCandCap};
  const int m = (int)(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < n && i < m; ++i) out[i] = c[i];
  return m + (n > m ? float_scan_constants(out + m, n - m) : 0);
}

// The stage count scan_float gives a tile, or < 2 when it does not fit.
int rc2_stream_topk_float_stages(int query_tile, int warp_queries, int tile_rows, int emb_bf16,
                          int k,
                                 int blocks_per_sm) {
  return float_scan_stages(query_tile, warp_queries, tile_rows, emb_bf16 ? 2 : 4, k,
                           blocks_per_sm);
}

// The bf16_tc regime's constants, in this order: store rows per tile, the
// four query tiles, candidate slots per query, the regime's smallest batch,
// the planes of a query.  Returns the count.
int rc2_stream_topk_tc_constants(int* out, int n) {
  const int c[] = {kTcRows, 32, 64, 96, 128, kTcCandCap, kTcMinQueries, kPlanes};
  const int m = (int)(sizeof(c) / sizeof(c[0]));
  for (int i = 0; i < n && i < m; ++i) out[i] = c[i];
  return m;
}

// The stage count scan_bf16_tc gives a query tile with `tiles` row tiles a
// stage at k, or < 2 when it does not fit.
int rc2_stream_topk_tc_stages(int query_tile, int tiles, int k) {
  return tc_stages(query_tile, tiles, k);
}

// Scratch entries per (query, k) slot: the chunks' candidates plus the
// first merge level's groups.
int rc2_stream_topk_scratch_chunks(int n_chunks) {
  return n_chunks + merge_groups_of(n_chunks);
}

// kind: 0 f32, 1 bf16, 2 int8 store.  mode: 0 float, 1 int8, 2 int8 2-pass
// (q holds 2B stacked rows: the B hi rows, then the B lo rows), 3 bf16_tc
// (a bf16 store, f32 queries split into `planes`, scratch of 3 x
// query_tile x D bf16 on 16 bytes, by the call; box_rows: the rows of a
// stage, 128 or 256).  The int8
// modes take q_scale (and q_scale_lo) [B], row_scale [N]; assign [N] and
// qc_t [n_codes, B] (the bias q . centroids^T, transposed) add the residual
// bias (both null without it).  query_tile picks the int8 regime: 16
// (small, the code block resident) or 64 / 128 / 256 code rows (large, staged);
// for f32 / bf16 it picks scan_float's tile, with box_rows (rows per
// stage) and blocks_per_sm.  The grid is n_chunks blocks of
// rows_per_chunk rows.
int rc2_stream_topk(const void* q, const void* emb, int kind, int mode,
                    const void* q_scale, const void* q_scale_lo,
                    const void* row_scale, const void* assign, const void* qc_t,
                    const void* mask, void* planes, int B, int N, int D, int k,
                    int query_tile,
                    int rows_per_chunk, int n_chunks, int box_rows, int blocks_per_sm,
                    void* cand_v, void* cand_i,
                    void* out_v, void* out_i, void* stream) {
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || B < 1 || N < 1 || D < 1 || n_chunks < 1 ||
      (long long)n_chunks * rows_per_chunk < N)
    return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
    FloatParams p;
    p.q = static_cast<const float*>(q);
    p.emb = emb;
    p.mask = static_cast<const uint8_t*>(mask);
    p.B = B;
    p.N = N;
    p.D = D;
    p.k = k;
    p.rows_per_chunk = rows_per_chunk;
    p.box_rows = box_rows;
    p.tma_box = 0;
    p.n_stages = 0;
    p.tma = 0;
    p.cand_v = static_cast<float*>(cand_v);
    p.cand_i = static_cast<int*>(cand_i);
    const int rc =
        launch_scan_float<false>(p, kind == 1, query_tile, n_chunks, blocks_per_sm, s);
    if (rc != 0) return rc;
    return (int)merge_levels(p.cand_v, p.cand_i, B, n_chunks, k, ov, oi, s);
  }
  if (mode == 3) {
    if (kind != 1 || planes == nullptr || B < kTcMinQueries) return (int)cudaErrorInvalidValue;
    TcParams p;
    p.emb = static_cast<const __nv_bfloat16*>(emb);
    p.mask = static_cast<const uint8_t*>(mask);
    p.B = B;
    p.N = N;
    p.D = D;
    p.k = k;
    p.rows_per_chunk = rows_per_chunk;
    p.n_stages = 0;
    p.cand_v = static_cast<float*>(cand_v);
    p.cand_i = static_cast<int*>(cand_i);
    return launch_bf16_tc_tile(query_tile, box_rows / kTcRows, p, static_cast<const float*>(q),
                               static_cast<__nv_bfloat16*>(planes), n_chunks, ov, oi, s);
  }
  if (kind != 2 || (mode != 1 && mode != 2)) return (int)cudaErrorInvalidValue;
  I8Params p;
  p.q = static_cast<const int8_t*>(q);
  p.emb = static_cast<const int8_t*>(emb);
  p.q_scale = static_cast<const float*>(q_scale);
  p.q_scale_lo = static_cast<const float*>(q_scale_lo);
  p.row_scale = static_cast<const float*>(row_scale);
  p.assign = static_cast<const int*>(assign);
  p.qc_t = static_cast<const float*>(qc_t);
  p.mask = static_cast<const uint8_t*>(mask);
  p.B = B;
  p.N = N;
  p.D = D;
  p.k = k;
  p.rows_per_chunk = rows_per_chunk;
  p.n_stages = 0;
  p.tma = 0;
  p.cand_v = static_cast<float*>(cand_v);
  p.cand_i = static_cast<int*>(cand_i);
  const int rows = mode == 2 ? 2 * B : B;
  if (rows > query_tile || (p.assign != nullptr && p.qc_t == nullptr))
    return (int)cudaErrorInvalidValue;
  return mode == 2 ? launch_i8_tile<true>(query_tile, p, n_chunks, ov, oi, s)
                   : launch_i8_tile<false>(query_tile, p, n_chunks, ov, oi, s);
}

const char* rc2_cuda_error_string(int e) {
  static char buf[96];
  if (e >= kTmaError) {
    std::snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed with CUresult %d",
                  e - kTmaError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
