// K1: fused dense score + running top-k for sm_90a.
//
// Replaces the TPU kernel rag_challenge_2_tpu/ops/pallas_topk.py
// (pallas_dense_topk -> _pallas_call, kernel _kernel, merge _merge_topk):
// scores Q . E^T over corpus tiles with a row-shared mask and keeps a
// per-query top-k on chip, so the [B, N] score matrix is never written to
// device memory.
//
// What bounds it on the H100: every call reads the N x D store once
// (N * D * itemsize bytes) and does 2 * B * N * D flops.  At the engine's
// B = 8 that is 16 flops per f32 byte (32 per bf16 byte), far below the
// card's compute-to-bandwidth ratio, so the kernel is memory-bound and its
// roofline is the store read at 3.35 TB/s.
//
// What the design does about it:
//   * pass 1 splits N into tiles of kTileRows rows, one block per tile (and
//     per group of kQB queries).  A warp scores kRowsPerIter rows at a
//     time with 16-byte coalesced loads (4 f32 or 8 bf16 per lane), so each
//     row is read exactly once; the block's queries sit in shared memory
//     and are reused across the rows.  Accumulation is IEEE f32 FMA on the
//     CUDA cores: the exact path the engine specifies (no TF32, no bf16
//     products; a bf16 row is widened with __bfloat162float).
//   * the tile's scores stay in shared memory; one warp per query selects
//     the tile's top-k by k rounds of "best entry strictly after the last
//     one taken" under the total order (value desc, row asc), and writes
//     k candidates per (query, tile).
//   * pass 2 merges the [B, n_tiles, k] candidates with the same selection
//     in levels: each block stages the candidates of kMergeGroup tiles in
//     shared memory and keeps their top-k, until one group is left
//     (250,000 rows: 977 tiles -> 16 -> 1).  Ties therefore go to the
//     lowest row, exactly like a stable descending sort of the masked
//     scores.
// Masked rows score NEG_INF (-3e38) and stay selectable after every real
// score, which reproduces the reference's overflow slots when k exceeds
// the routed rows.  wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQB = kWarps;  // queries per block: one selecting warp each
constexpr int kTileRows = 256;
constexpr int kRowsPerIter = 4;
constexpr int kMergeGroup = 64;  // tiles merged per block and level
constexpr float kNegInf = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 raw bytes -> 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float* x) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) x[i] = to_float(e[i]);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    score_tiles(const float* __restrict__ q, const T* __restrict__ emb,
                const uint8_t* __restrict__ mask, int B, int N, int D, int k,
                float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kQB][D]
  float* s_s = q_s + (size_t)kQB * D;           // [kQB][kTileRows]
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int b0 = blockIdx.y * kQB;
  const int r0 = tile * kTileRows;
  const int rows = min(kTileRows, N - r0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kQB * D; i += kThreads) {
    q_s[i] = (b0 + i / D) < B ? q[(size_t)b0 * D + i] : 0.f;
  }
  __syncthreads();

  for (int rr = warp * kRowsPerIter; rr < rows;
       rr += kWarps * kRowsPerIter) {
    float acc[kQB][kRowsPerIter];
#pragma unroll
    for (int b = 0; b < kQB; ++b)
#pragma unroll
      for (int r = 0; r < kRowsPerIter; ++r) acc[b][r] = 0.f;
    const T* rowp[kRowsPerIter];
#pragma unroll
    for (int r = 0; r < kRowsPerIter; ++r) {
      // rows past the tile re-read row rr; their sums are discarded
      const int lr = rr + r < rows ? rr + r : rr;
      rowp[r] = emb + (size_t)(r0 + lr) * D;
    }
    if constexpr (kVec) {
      constexpr int E = 16 / sizeof(T);
      for (int d = lane * E; d < D; d += 32 * E) {
        float x[kRowsPerIter][E];
#pragma unroll
        for (int r = 0; r < kRowsPerIter; ++r) {
          widen<T>(*reinterpret_cast<const uint4*>(rowp[r] + d), x[r]);
        }
#pragma unroll
        for (int b = 0; b < kQB; ++b) {
          const float4* qp = reinterpret_cast<const float4*>(q_s + b * D + d);
#pragma unroll
          for (int e4 = 0; e4 < E / 4; ++e4) {
            const float4 qv = qp[e4];
#pragma unroll
            for (int r = 0; r < kRowsPerIter; ++r) {
              float a = acc[b][r];
              a = fmaf(qv.x, x[r][4 * e4 + 0], a);
              a = fmaf(qv.y, x[r][4 * e4 + 1], a);
              a = fmaf(qv.z, x[r][4 * e4 + 2], a);
              a = fmaf(qv.w, x[r][4 * e4 + 3], a);
              acc[b][r] = a;
            }
          }
        }
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        float x[kRowsPerIter];
#pragma unroll
        for (int r = 0; r < kRowsPerIter; ++r) x[r] = to_float(rowp[r][d]);
#pragma unroll
        for (int b = 0; b < kQB; ++b) {
          const float qv = q_s[b * D + d];
#pragma unroll
          for (int r = 0; r < kRowsPerIter; ++r)
            acc[b][r] = fmaf(qv, x[r], acc[b][r]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kQB; ++b)
#pragma unroll
      for (int r = 0; r < kRowsPerIter; ++r)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[b][r] += __shfl_xor_sync(kFull, acc[b][r], off);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRowsPerIter; ++r) {
        if (rr + r >= rows) break;
        const bool ok = mask == nullptr || mask[r0 + rr + r] != 0;
#pragma unroll
        for (int b = 0; b < kQB; ++b)
          s_s[b * kTileRows + rr + r] = ok ? acc[b][r] : kNegInf;
      }
    }
  }
  __syncthreads();

  const int b = b0 + warp;
  if (b >= B) return;  // warp-uniform
  const float* s = s_s + warp * kTileRows;
  float pv = 0.f;
  int pr = 0;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int br = INT_MAX;
    for (int i = lane; i < rows; i += 32) {
      const float v = s[i];
      const int r = r0 + i;
      if ((j == 0 || better(pv, pr, v, r)) && better(v, r, bv, br)) {
        bv = v;
        br = r;
      }
    }
    warp_best(bv, br);
    if (lane == 0) {
      const size_t o = ((size_t)b * n_tiles + tile) * k + j;
      cand_v[o] = bv;
      cand_i[o] = br;
    }
    pv = bv;
    pr = br;
  }
}

// One merge level: block (g, b) stages the candidates of tiles
// [g * kMergeGroup, (g + 1) * kMergeGroup) of query b in shared memory and
// selects their top-k into out[b][g].  Every group's top-k holds all of
// the global top-k that fall in it, so repeating levels until one group
// is left yields the exact top-k under the same total order.
__global__ void __launch_bounds__(kThreads)
    merge_groups(const float* __restrict__ in_v, const int* __restrict__ in_i,
                 int n, int k, float* __restrict__ out_v,
                 int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float* sv = reinterpret_cast<float*>(smem4);  // [kMergeGroup * k]
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
        out_v[dst + j] = bv;
        out_i[dst + j] = br;
      }
    }
    __syncthreads();
    pv = sel_v;
    pr = sel_r;
  }
}

int merge_scratch_tiles(int n_tiles) {
  return (n_tiles + kMergeGroup - 1) / kMergeGroup;
}

template <typename T>
cudaError_t launch(const float* q, const T* emb, const uint8_t* mask, int B,
                   int N, int D, int k, float* cand_v, int* cand_i,
                   float* out_v, int* out_i, cudaStream_t stream) {
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const dim3 grid(n_tiles, (B + kQB - 1) / kQB);
  const size_t smem = ((size_t)kQB * D + (size_t)kQB * kTileRows) * sizeof(float);
  constexpr int E = 16 / sizeof(T);
  const bool vec = D % E == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  auto kernel = vec ? score_tiles<T, true> : score_tiles<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(q, emb, mask, B, N, D, k, cand_v,
                                           cand_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // merge levels ping-pong between the scratch tail (after the
  // [B, n_tiles, k] candidates) and the candidate area itself
  float* tmp_v = cand_v + (size_t)B * n_tiles * k;
  int* tmp_i = cand_i + (size_t)B * n_tiles * k;
  const float* in_v = cand_v;
  const int* in_i = cand_i;
  const size_t msmem = (size_t)kMergeGroup * k * (sizeof(float) + sizeof(int));
  for (int n = n_tiles, level = 0;; ++level) {
    const int groups = merge_scratch_tiles(n);
    float* o_v = groups == 1 ? out_v : (level % 2 == 0 ? tmp_v : cand_v);
    int* o_i = groups == 1 ? out_i : (level % 2 == 0 ? tmp_i : cand_i);
    merge_groups<<<dim3(groups, B), kThreads, msmem, stream>>>(in_v, in_i, n,
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

int rc2_dense_topk_tile_rows() { return kTileRows; }

// Scratch entries per (query, k) slot: n_tiles candidates plus the first
// merge level's groups.
int rc2_dense_topk_scratch_tiles(int n_tiles) {
  return n_tiles + merge_scratch_tiles(n_tiles);
}

// q: f32 [B, D]; emb: f32 or bf16 [N, D] row-major; mask: u8 [N] or null;
// cand_v/cand_i: scratch of B * scratch_tiles(n_tiles) * k entries;
// out: [B, k].
int rc2_dense_topk(const void* q, const void* emb, int emb_bf16,
                   const void* mask, int B, int N, int D, int k, void* cand_v,
                   void* cand_i, void* out_v, void* out_i, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  if (emb_bf16) {
    return (int)launch(qf, static_cast<const __nv_bfloat16*>(emb), m, B, N, D,
                       k, cv, ci, ov, oi, s);
  }
  return (int)launch(qf, static_cast<const float*>(emb), m, B, N, D, k, cv,
                     ci, ov, oi, s);
}

const char* rc2_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
