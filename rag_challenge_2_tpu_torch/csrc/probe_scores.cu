// K4: IVF probe span scores for sm_90a.
//
// Replaces the TPU kernel rag_challenge_2_tpu/ops/pallas_ivf.py
// (probe_span_scores): for G (query, probe) pairs, the inner products of
// the pair's query with the W rows of its probed list, which are the
// contiguous span emb_perm[start : start + W] of the cluster-ordered store:
//
//   out[g, j] = sum_d q[g, d] * emb_perm[clip(start[g] + j, 0, n_rows - 1), d]
//
// as [G, W] f32.  The query has the store's dtype: int8 codes multiply in
// int8 x int8 and accumulate exactly in int32 (__dp4a on 4-byte words);
// f32 rows take IEEE f32 FMAs (no TF32: the reference's r03 IVF recall
// regression was exactly that precision loss); bf16 rows and the bf16
// query both widen to f32, whose product of two bf16 values is exact, and
// accumulate as f32 FMAs.  Positions are clamped to the store like the
// reference's XLA path, so the kernel needs no list alignment or slack and
// is defined on any input; out-of-list positions are masked by the caller.
//
// What bounds it on the H100: the span read, G * W * D * itemsize bytes
// (at the IVF-1M probe, 127 queries x 8 probes x ~500 rows x 4 KB, about
// 2 GB for an f32 store) against 3.35 TB/s.  Each row is used by one query
// only, so there is no reuse to win with tensor cores: 2 flops per byte
// for f32, far below the card's ridge point.
//
// What the design does about it: blocks of 256 threads each take 64 rows
// of one span, so G * ceil(W / 64) blocks fill the 132 SMs.  The block
// stages its query in shared memory once.  Each warp takes whole rows:
// consecutive lanes load consecutive 16-byte chunks of the row (a warp
// reads 512 contiguous bytes per instruction), multiply them with the
// matching chunk of the staged query, and one warp-shuffle reduction per
// row gives the dot product.  Rows whose start is not 16-byte aligned (a
// row of D * itemsize bytes that is not a multiple of 16, or a store that
// is an unaligned view) take the element path: lanes on consecutive
// elements, one element each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 64;

enum Kind { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int KIND>
__host__ __device__ constexpr int item_bytes() {
  return KIND == kF32 ? 4 : (KIND == kBF16 ? 2 : 1);
}

// the two bf16 values of a 32-bit word, widened exactly to f32
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int KIND>
__device__ __forceinline__ void dot_word(uint32_t a, uint32_t b, float& f,
                                         int& i) {
  if constexpr (KIND == kF32) {
    f = fmaf(__uint_as_float(a), __uint_as_float(b), f);
  } else if constexpr (KIND == kBF16) {
    f = fmaf(bf16_lo(a), bf16_lo(b), f);
    f = fmaf(bf16_hi(a), bf16_hi(b), f);
  } else {
    i = __dp4a(static_cast<int>(a), static_cast<int>(b), i);
  }
}

template <int KIND>
__device__ __forceinline__ void dot_elem(const unsigned char* row,
                                         const unsigned char* q, int d,
                                         float& f, int& i) {
  if constexpr (KIND == kF32) {
    f = fmaf(reinterpret_cast<const float*>(row)[d],
             reinterpret_cast<const float*>(q)[d], f);
  } else if constexpr (KIND == kBF16) {
    const uint32_t a = reinterpret_cast<const uint16_t*>(row)[d];
    const uint32_t b = reinterpret_cast<const uint16_t*>(q)[d];
    f = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), f);
  } else {
    i += static_cast<int>(reinterpret_cast<const int8_t*>(row)[d]) *
         static_cast<int>(reinterpret_cast<const int8_t*>(q)[d]);
  }
}

template <int KIND, bool VEC>
__global__ void __launch_bounds__(kThreads)
    probe_scores(const unsigned char* __restrict__ emb,
                 const unsigned char* __restrict__ q,
                 const int* __restrict__ starts, long long n_rows, int dim,
                 int window, int blocks_per_span, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char q_s[];
  const long long row_bytes = (long long)dim * item_bytes<KIND>();
  const int g = blockIdx.x / blocks_per_span;
  const int j0 = (blockIdx.x % blocks_per_span) * kRowsPerBlock;

  const unsigned char* qg = q + (size_t)g * row_bytes;
  for (long long b = threadIdx.x; b < row_bytes; b += kThreads) q_s[b] = qg[b];
  __syncthreads();

  const long long s = starts[g];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int j = j0 + r;
    if (j >= window) break;  // uniform across the warp
    long long p = s + j;
    p = p < 0 ? 0 : (p >= n_rows ? n_rows - 1 : p);
    const unsigned char* row = emb + p * row_bytes;
    float f = 0.f;
    int acc = 0;
    if constexpr (VEC) {
      const uint4* row4 = reinterpret_cast<const uint4*>(row);
      const uint4* q4 = reinterpret_cast<const uint4*>(q_s);
      const int n16 = (int)(row_bytes / 16);
#pragma unroll 4
      for (int c = lane; c < n16; c += 32) {
        const uint4 a = __ldg(row4 + c);
        const uint4 b = q4[c];
        dot_word<KIND>(a.x, b.x, f, acc);
        dot_word<KIND>(a.y, b.y, f, acc);
        dot_word<KIND>(a.z, b.z, f, acc);
        dot_word<KIND>(a.w, b.w, f, acc);
      }
    } else {
      for (int d = lane; d < dim; d += 32) dot_elem<KIND>(row, q_s, d, f, acc);
    }
    float v;
    if constexpr (KIND == kI8) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      v = (float)acc;
    } else {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) f += __shfl_xor_sync(0xffffffffu, f, o);
      v = f;
    }
    if (lane == 0) out[(size_t)g * window + j] = v;
  }
}

template <int KIND>
void launch(const void* emb, const void* q, const void* starts,
            long long n_rows, int dim, int G, int window, float* out,
            cudaStream_t stream) {
  const long long row_bytes = (long long)dim * item_bytes<KIND>();
  const size_t smem = (size_t)((row_bytes + 15) / 16 * 16);
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  const int per_span = (window + kRowsPerBlock - 1) / kRowsPerBlock;
  const unsigned int blocks = (unsigned int)((long long)G * per_span);
  const auto* e = static_cast<const unsigned char*>(emb);
  const auto* qq = static_cast<const unsigned char*>(q);
  const auto* st = static_cast<const int*>(starts);
  if (vec) {
    probe_scores<KIND, true><<<blocks, kThreads, smem, stream>>>(
        e, qq, st, n_rows, dim, window, per_span, out);
  } else {
    probe_scores<KIND, false><<<blocks, kThreads, smem, stream>>>(
        e, qq, st, n_rows, dim, window, per_span, out);
  }
}

}  // namespace

extern "C" {

// Rows per block: the wrapper needs it to bound the grid.
int rc2_probe_scores_rows_per_block() { return kRowsPerBlock; }

// emb: [n_rows, dim] of kind (0 f32, 1 bf16, 2 int8); q: [G, dim] of the
// same kind; starts: i32 [G]; out: f32 [G, window].
int rc2_probe_scores(const void* emb, const void* q, const void* starts,
                     long long n_rows, int dim, int kind, int G, int window,
                     void* out, void* stream) {
  if (G > 0 && window > 0) {
    auto* o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if (kind == kF32) {
      launch<kF32>(emb, q, starts, n_rows, dim, G, window, o, s);
    } else if (kind == kBF16) {
      launch<kBF16>(emb, q, starts, n_rows, dim, G, window, o, s);
    } else if (kind == kI8) {
      launch<kI8>(emb, q, starts, n_rows, dim, G, window, o, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

const char* rc2_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
