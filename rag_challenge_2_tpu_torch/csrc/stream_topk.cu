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
// What bounds it on the H100: every call reads the N x D store once from
// HBM and does B * N * D multiply-adds.  At the 10M-row int8 scan
// (B = 127) that is 254 int8 operations per store byte: reading 10.2 GB
// takes ~3 ms at 3.35 TB/s, while 1.3e12 multiply-adds at the __dp4a
// issue rate (64 per SM and clock, 4 products each) take ~20 ms.  The
// kernel is therefore bound by the dp4a issue rate, not the read (the
// 2-pass query doubles the work on the same bytes); f32 and bf16 are bound
// the same way by the CUDA cores' FMA rate.
//
// What the design does about it:
//   * each block owns a group of 64 query rows (32 logical queries x
//     {hi, lo} in 2-pass) and a contiguous row range ("chunk") of the
//     store, and walks it in tiles of 64 rows.  Each tile goes through a
//     3-stage cp.async ring in shared memory as D-chunks of 128 bytes per
//     store row (the query rows' matching slice rides in the same stage),
//     so the loads of the next stages overlap the arithmetic of this one.
//     Each query group reads the store once, so a call reads it
//     ceil(B / 64) times (twice at B = 127, four times in 2-pass).  The
//     query groups of one chunk are neighbours in the grid (blockIdx.x),
//     so they run at the same time and all but the first should find the
//     chunk's tiles in the 50 MB L2, leaving about one HBM read per call
//     (the hit rate is not measured; the read is not the bound anyway).
//   * every thread keeps a 4 x 4 register tile of (query row, store row)
//     sums; each 16-byte shared-memory load feeds 16 products (64 for
//     int8 via __dp4a), and rows are padded by 16 bytes so the loads are
//     free of bank conflicts.  f32 and bf16 accumulate in IEEE f32 FMA
//     (bf16 widened exactly, no TF32, no bf16 products); int8 accumulates
//     exactly in int32 and applies the epilogue of int8_scores in the JAX
//     order with __fmul_rn / __fadd_rn, so scores are bitwise equal to
//     the plain version: (acc * q_scale) * row_scale, or
//     (acc_hi * s_hi + acc_lo * s_lo) * row_scale, then + qc[b, assign].
//   * the per-query top-k and its k-th value stay in shared memory for
//     the whole chunk.  A tile's scores go to shared memory; the warp that
//     owns a query merges only when some score beats that query's k-th
//     (strictly, as any_better), by ranking the new candidates against
//     the sorted list (binary search) and against each other.  After the
//     first tiles almost no tile merges, so the steady state is the
//     product alone.
//   * each block writes its k candidates per query; a second pass merges
//     them under (value desc, row asc) in levels of 64 chunks, as K1's
//     merge does.  Ties therefore go to the lowest row.  Masked rows never
//     enter (a score must beat NEG_INF), so slots past the eligible rows
//     keep row -1 and NEG_INF, as the Pallas kernel and blocked_topk
//     return them.
// Tensor-core products (mma.sync / wgmma on int8, bf16) and a variant with
// fewer query rows per block for small batches are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQRows = 64;        // query rows per block (stacked in 2-pass)
constexpr int kTileRows = 64;     // store rows per tile
constexpr int kStages = 3;        // depth of the cp.async ring
constexpr int kPadBytes = 16;     // shared-memory row padding
constexpr int kMaxK = 64;
constexpr int kScoreStride = kTileRows + 2;
constexpr int kMergeGroup = 64;   // chunk lists merged per block and level
constexpr float kNegInf = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kFloat = 0, kInt8 = 1, kInt8TwoPass = 2 };

// Per store element type: the query element kept in shared memory (QT),
// the raw bits type for the element path, and the store elements per
// D-chunk (kDC) of one stage.
template <typename ET> struct Elem;
template <> struct Elem<float> {
  using QT = float;
  using Raw = uint32_t;
  static constexpr int kDC = 32;
};
template <> struct Elem<__nv_bfloat16> {
  using QT = float;
  using Raw = uint16_t;
  static constexpr int kDC = 32;
};
template <> struct Elem<int8_t> {
  using QT = int8_t;
  using Raw = uint8_t;
  static constexpr int kDC = 128;
};

template <typename ET>
struct Layout {
  using QT = typename Elem<ET>::QT;
  static constexpr int kDC = Elem<ET>::kDC;
  static constexpr int kQBytes = kDC * (int)sizeof(QT);   // 128
  static constexpr int kTBytes = kDC * (int)sizeof(ET);   // 128, 64, 128
  static constexpr int kQStride = kQBytes + kPadBytes;
  static constexpr int kTStride = kTBytes + kPadBytes;
  static constexpr int kStageBytes = kQRows * kQStride + kTileRows * kTStride;
  static constexpr int kSmemBytes = kStages * kStageBytes +
                                    kQRows * kScoreStride * (int)sizeof(float) +
                                    kQRows * kMaxK * (int)(sizeof(float) + sizeof(int));
};

struct Params {
  const void* q;            // [Bq, D]: f32 (f32/bf16 stores) or int8 codes
  const void* emb;          // [N, D] row-major
  const float* q_scale;     // [B] int8: the query scale (s_hi in 2-pass)
  const float* q_scale_lo;  // [B] 2-pass: s_lo
  const float* row_scale;   // [N] int8: per-row scale
  const int* assign;        // [N] residual: centroid id per row, or null
  const float* qc;          // [B, n_codes] residual: q . centroids^T
  const uint8_t* mask;      // [N] row mask shared by all queries, or null
  int n_codes;
  int B;                    // logical queries
  int N;
  int D;
  int k;
  int rows_per_chunk;
  float* cand_v;            // [B, n_chunks, k]
  int* cand_i;
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void bf16x8(const uint4& raw, float* x) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(e[i]);
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

template <typename ET, int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) stream_tiles(Params p) {
  using L = Layout<ET>;
  using QT = typename L::QT;
  using Raw = typename Elem<ET>::Raw;
  using Acc = typename std::conditional<kMode == kFloat, float, int>::type;
  constexpr bool kTwoPass = kMode == kInt8TwoPass;
  constexpr int kLQ = kTwoPass ? kQRows / 2 : kQRows;  // logical queries
  constexpr int kQPieces = L::kQBytes / 16;
  constexpr int kTPieces = L::kTBytes / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tile = reinterpret_cast<float*>(smem + kStages * L::kStageBytes);
  float* top_v = s_tile + kQRows * kScoreStride;
  int* top_i = reinterpret_cast<int*>(top_v + kQRows * kMaxK);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b0 = blockIdx.x * kLQ;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int r_begin = chunk * p.rows_per_chunk;
  const int r_end = min(p.N, r_begin + p.rows_per_chunk);
  const int n_tiles =
      r_end > r_begin ? (r_end - r_begin + kTileRows - 1) / kTileRows : 0;
  const int n_dch = (p.D + L::kDC - 1) / L::kDC;
  const int total = n_tiles * n_dch;
  const int k = p.k;
  const QT* qg = static_cast<const QT*>(p.q);
  const ET* eg = static_cast<const ET*>(p.emb);

  for (int i = tid; i < kQRows * kMaxK; i += kThreads) {
    top_v[i] = kNegInf;
    top_i[i] = -1;
  }

  // stage s = (tile s / n_dch, D-chunk s % n_dch) into ring slot `slot`
  auto load_stage = [&](int s, int slot) {
    const int t = s / n_dch;
    const int c = s % n_dch;
    unsigned char* qs = smem + slot * L::kStageBytes;
    unsigned char* ts = qs + kQRows * L::kQStride;
    const int row0 = r_begin + t * kTileRows;
    for (int u = tid; u < kQRows * kQPieces; u += kThreads) {
      const int i = u / kQPieces;
      const int piece = u % kQPieces;
      const int lq = kTwoPass ? i >> 1 : i;
      const int src = b0 + lq < p.B ? (kTwoPass ? (i & 1) * p.B + b0 + lq : b0 + lq) : -1;
      constexpr int kPer = 16 / (int)sizeof(QT);
      const int d0 = c * L::kDC + piece * kPer;
      unsigned char* dst = qs + i * L::kQStride + piece * 16;
      if constexpr (kVec) {
        const bool ok = src >= 0 && d0 < p.D;
        cp_async16(dst, ok ? qg + (size_t)src * p.D + d0 : qg, ok);
      } else {
        QT* d = reinterpret_cast<QT*>(dst);
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          d[e] = (src >= 0 && d0 + e < p.D) ? qg[(size_t)src * p.D + d0 + e]
                                            : QT(0);
        }
      }
    }
    for (int u = tid; u < kTileRows * kTPieces; u += kThreads) {
      const int i = u / kTPieces;
      const int piece = u % kTPieces;
      const int row = row0 + i;
      constexpr int kPer = 16 / (int)sizeof(ET);
      const int d0 = c * L::kDC + piece * kPer;
      unsigned char* dst = ts + i * L::kTStride + piece * 16;
      if constexpr (kVec) {
        const bool ok = row < r_end && d0 < p.D;
        cp_async16(dst, ok ? eg + (size_t)row * p.D + d0 : eg, ok);
      } else {
        const Raw* src = reinterpret_cast<const Raw*>(eg);
        Raw* d = reinterpret_cast<Raw*>(dst);
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          d[e] = (row < r_end && d0 + e < p.D) ? src[(size_t)row * p.D + d0 + e]
                                               : Raw(0);
        }
      }
    }
  };

  // this thread's 4 x 4 register tile: query-tile rows qr0 .. qr0 + 3 and
  // store-tile rows tr0 + 8 j (8 neighbouring lanes read 8 neighbouring
  // store rows and one broadcast query row)
  const int wq = warp % 4;
  const int wr = warp / 4;
  const int qr0 = wq * 16 + (lane / 8) * 4;
  const int tr0 = wr * 32 + lane % 8;

  // per-query epilogue constants of this thread's logical queries
  float qs1[4] = {0.f, 0.f, 0.f, 0.f};
  float qs2[2] = {0.f, 0.f};
  const float* qc_row[4] = {nullptr, nullptr, nullptr, nullptr};
  if constexpr (kMode != kFloat) {
    constexpr int kMine = kTwoPass ? 2 : 4;
#pragma unroll
    for (int h = 0; h < kMine; ++h) {
      const int b = b0 + (kTwoPass ? qr0 / 2 + h : qr0 + h);
      if (b < p.B) {
        qs1[h] = p.q_scale[b];
        if constexpr (kTwoPass) qs2[h] = p.q_scale_lo[b];
        if (p.assign != nullptr) qc_row[h] = p.qc + (size_t)b * p.n_codes;
      }
    }
  }

  Acc acc[4][4];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(s, s);
    cp_async_commit();
  }
  __syncthreads();

  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; every thread is done with slot s - 1
    {
      const int nx = s + kStages - 1;
      if (nx < total) load_stage(nx, nx % kStages);
      cp_async_commit();
    }
    const int c = s % n_dch;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);
    }
    const unsigned char* qs = smem + (s % kStages) * L::kStageBytes;
    const unsigned char* ts = qs + kQRows * L::kQStride;
    if constexpr (std::is_same<ET, float>::value) {
#pragma unroll
      for (int piece = 0; piece < kTPieces; ++piece) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + (qr0 + i) * L::kQStride + piece * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(ts + (tr0 + 8 * j) * L::kTStride + piece * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x = acc[i][j];
            x = fmaf(a[i].x, b[j].x, x);
            x = fmaf(a[i].y, b[j].y, x);
            x = fmaf(a[i].z, b[j].z, x);
            x = fmaf(a[i].w, b[j].w, x);
            acc[i][j] = x;
          }
      }
    } else if constexpr (std::is_same<ET, __nv_bfloat16>::value) {
#pragma unroll
      for (int piece = 0; piece < kTPieces; ++piece) {  // 8 elements each
        float b[4][8];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bf16x8(*reinterpret_cast<const uint4*>(ts + (tr0 + 8 * j) * L::kTStride + piece * 16),
                 b[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a0 = *reinterpret_cast<const float4*>(
              qs + (qr0 + i) * L::kQStride + piece * 32);
          const float4 a1 = *reinterpret_cast<const float4*>(
              qs + (qr0 + i) * L::kQStride + piece * 32 + 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x = acc[i][j];
            x = fmaf(a0.x, b[j][0], x);
            x = fmaf(a0.y, b[j][1], x);
            x = fmaf(a0.z, b[j][2], x);
            x = fmaf(a0.w, b[j][3], x);
            x = fmaf(a1.x, b[j][4], x);
            x = fmaf(a1.y, b[j][5], x);
            x = fmaf(a1.z, b[j][6], x);
            x = fmaf(a1.w, b[j][7], x);
            acc[i][j] = x;
          }
        }
      }
    } else {
#pragma unroll
      for (int piece = 0; piece < kTPieces; ++piece) {
        int4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const int4*>(qs + (qr0 + i) * L::kQStride + piece * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const int4*>(ts + (tr0 + 8 * j) * L::kTStride + piece * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int x = acc[i][j];
            x = __dp4a(a[i].x, b[j].x, x);
            x = __dp4a(a[i].y, b[j].y, x);
            x = __dp4a(a[i].z, b[j].z, x);
            x = __dp4a(a[i].w, b[j].w, x);
            acc[i][j] = x;
          }
      }
    }
    if (c != n_dch - 1) continue;

    // ---- the tile is scored: epilogue into shared memory, then merge
    const int row0 = r_begin + (s / n_dch) * kTileRows;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lr = tr0 + 8 * j;
      const int row = row0 + lr;
      const bool ok = row < r_end && (p.mask == nullptr || p.mask[row] != 0);
      if constexpr (kMode == kFloat) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s_tile[(qr0 + i) * kScoreStride + lr] = ok ? acc[i][j] : kNegInf;
      } else {
        const float rs = ok ? p.row_scale[row] : 0.f;
        const int a = ok && p.assign != nullptr ? p.assign[row] : 0;
        constexpr int kMine = kTwoPass ? 2 : 4;
#pragma unroll
        for (int h = 0; h < kMine; ++h) {
          float v;
          if constexpr (kTwoPass) {
            v = __fmul_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc[2 * h][j]), qs1[h]),
                                    __fmul_rn(__int2float_rn(acc[2 * h + 1][j]), qs2[h])),
                          rs);
          } else {
            v = __fmul_rn(__fmul_rn(__int2float_rn(acc[h][j]), qs1[h]), rs);
          }
          if (qc_row[h] != nullptr) v = __fadd_rn(v, ok ? qc_row[h][a] : 0.f);
          const int lq = kTwoPass ? qr0 / 2 + h : qr0 + h;
          s_tile[lq * kScoreStride + lr] = ok ? v : kNegInf;
        }
      }
    }
    __syncthreads();

    // one warp per logical query; merge only when a score beats the k-th
    for (int lq = warp; lq < kLQ; lq += kWarps) {
      if (b0 + lq >= p.B) break;  // warp-uniform
      float* tv = top_v + lq * kMaxK;
      int* ti = top_i + lq * kMaxK;
      const float* st = s_tile + lq * kScoreStride;
      const float kth = tv[k - 1];
      const float v0 = st[lane];
      const float v1 = st[lane + 32];
      const int rw0 = row0 + lane;
      const int rw1 = row0 + lane + 32;
      const bool c0 = v0 > kth;
      const bool c1 = v1 > kth;
      const unsigned m0 = __ballot_sync(kFull, c0);
      const unsigned m1 = __ballot_sync(kFull, c1);
      if ((m0 | m1) == 0u) continue;
      const float e0v = lane < k ? tv[lane] : kNegInf;
      const int e0r = lane < k ? ti[lane] : -1;
      const float e1v = lane + 32 < k ? tv[lane + 32] : kNegInf;
      const int e1r = lane + 32 < k ? ti[lane + 32] : -1;
      // new position = entries better than it, in the list and among the
      // tile's candidates; positions >= k drop out
      int pe0 = lane, pe1 = lane + 32, pc0 = 0, pc1 = 0;
      for (int half = 0; half < 2; ++half) {
        for (unsigned bits = half ? m1 : m0; bits != 0u; bits &= bits - 1) {
          const int t = __ffs(bits) - 1 + 32 * half;
          const float yv = st[t];
          const int yr = row0 + t;
          pe0 += better(yv, yr, e0v, e0r);
          pe1 += better(yv, yr, e1v, e1r);
          pc0 += better(yv, yr, v0, rw0);
          pc1 += better(yv, yr, v1, rw1);
        }
      }
      if (c0) pc0 += count_better(tv, ti, k, v0, rw0);
      if (c1) pc1 += count_better(tv, ti, k, v1, rw1);
      __syncwarp();
      if (lane < k && pe0 < k) {
        tv[pe0] = e0v;
        ti[pe0] = e0r;
      }
      if (lane + 32 < k && pe1 < k) {
        tv[pe1] = e1v;
        ti[pe1] = e1r;
      }
      if (c0 && pc0 < k) {
        tv[pc0] = v0;
        ti[pc0] = rw0;
      }
      if (c1 && pc1 < k) {
        tv[pc1] = v1;
        ti[pc1] = rw1;
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int lq = warp; lq < kLQ; lq += kWarps) {
    const int b = b0 + lq;
    if (b >= p.B) break;
    for (int j = lane; j < k; j += 32) {
      const size_t o = ((size_t)b * n_chunks + chunk) * k + j;
      p.cand_v[o] = top_v[lq * kMaxK + j];
      p.cand_i[o] = top_i[lq * kMaxK + j];
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

template <typename ET, int kMode>
cudaError_t launch(const Params& p, int n_chunks, float* out_v, int* out_i,
                   cudaStream_t stream) {
  using L = Layout<ET>;
  constexpr int kLQ = kMode == kInt8TwoPass ? kQRows / 2 : kQRows;
  using QT = typename L::QT;
  const bool vec = (size_t)p.D * sizeof(ET) % 16 == 0 &&
                   (size_t)p.D * sizeof(QT) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.emb) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.q) % 16 == 0;
  auto kernel = vec ? stream_tiles<ET, kMode, true> : stream_tiles<ET, kMode, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.B + kLQ - 1) / kLQ, n_chunks);
  kernel<<<grid, kThreads, L::kSmemBytes, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // merge levels ping-pong between the scratch tail (after the
  // [B, n_chunks, k] candidates) and the candidate area itself
  const int k = p.k;
  float* tmp_v = p.cand_v + (size_t)p.B * n_chunks * k;
  int* tmp_i = p.cand_i + (size_t)p.B * n_chunks * k;
  const float* in_v = p.cand_v;
  const int* in_i = p.cand_i;
  const size_t msmem = (size_t)kMergeGroup * k * (sizeof(float) + sizeof(int));
  for (int n = n_chunks, level = 0;; ++level) {
    const int groups = merge_groups_of(n);
    float* o_v = groups == 1 ? out_v : (level % 2 == 0 ? tmp_v : p.cand_v);
    int* o_i = groups == 1 ? out_i : (level % 2 == 0 ? tmp_i : p.cand_i);
    merge_groups<<<dim3(groups, p.B), kThreads, msmem, stream>>>(in_v, in_i, n,
                                                                 k, o_v, o_i);
    e = cudaGetLastError();
    if (e != cudaSuccess || groups == 1) return e;
    in_v = o_v;
    in_i = o_i;
    n = groups;
  }
}

}  // namespace

extern "C" {

int rc2_stream_topk_tile_rows() { return kTileRows; }

int rc2_stream_topk_query_rows() { return kQRows; }

// Scratch entries per (query, k) slot: the chunks' candidates plus the
// first merge level's groups.
int rc2_stream_topk_scratch_chunks(int n_chunks) {
  return n_chunks + merge_groups_of(n_chunks);
}

// kind: 0 f32, 1 bf16, 2 int8 store.  mode: 0 float, 1 int8, 2 int8 2-pass
// (q holds 2B stacked rows: the B hi rows, then the B lo rows).  The int8
// modes take q_scale (and q_scale_lo) [B], row_scale [N]; assign [N] and
// qc [B, n_codes] add the residual bias (both null without it).
int rc2_stream_topk(const void* q, const void* emb, int kind, int mode,
                    const void* q_scale, const void* q_scale_lo,
                    const void* row_scale, const void* assign, const void* qc,
                    int n_codes, const void* mask, int B, int N, int D, int k,
                    int rows_per_chunk, int n_chunks, void* cand_v,
                    void* cand_i, void* out_v, void* out_i, void* stream) {
  Params p;
  p.q = q;
  p.emb = emb;
  p.q_scale = static_cast<const float*>(q_scale);
  p.q_scale_lo = static_cast<const float*>(q_scale_lo);
  p.row_scale = static_cast<const float*>(row_scale);
  p.assign = static_cast<const int*>(assign);
  p.qc = static_cast<const float*>(qc);
  p.mask = static_cast<const uint8_t*>(mask);
  p.n_codes = n_codes;
  p.B = B;
  p.N = N;
  p.D = D;
  p.k = k;
  p.rows_per_chunk = rows_per_chunk;
  p.cand_v = static_cast<float*>(cand_v);
  p.cand_i = static_cast<int*>(cand_i);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0 && mode == kFloat) return (int)launch<float, kFloat>(p, n_chunks, ov, oi, s);
  if (kind == 1 && mode == kFloat)
    return (int)launch<__nv_bfloat16, kFloat>(p, n_chunks, ov, oi, s);
  if (kind == 2 && mode == kInt8) return (int)launch<int8_t, kInt8>(p, n_chunks, ov, oi, s);
  if (kind == 2 && mode == kInt8TwoPass)
    return (int)launch<int8_t, kInt8TwoPass>(p, n_chunks, ov, oi, s);
  return (int)cudaErrorInvalidValue;
}

const char* rc2_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
