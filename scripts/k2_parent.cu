// The span gather (K2) as it stood before its redesign for Hopper: one
// block per span, 16-byte loads then 4-byte stores, array after array.
// Kept only as the timing baseline of the redesigned kernel
// (rag_challenge_2_tpu_torch/csrc/span_gather.cu): chip_smoke.py and
// scripts/k2_sweep.py time both under one timer.  The port never calls it.
//
// K2: posting-span gather for sm_90a.
//
// Replaces the TPU kernel rag_challenge_2_tpu/ops/pallas_bm25.py
// (gather_posting_spans): for G start offsets, copy the window-wide
// contiguous spans [start, start + window) of two or three parallel flat
// CSR arrays (i32 chunk ids, f32 term frequencies, optional f32 per-posting
// doc lengths) into [G, window] outputs.
//
// What bounds it on the H100: it is a pure copy.  It moves
// G * window * 4 bytes per array in and out, about 1 MB per array at the
// engine's 8 queries x 64 terms x 512 window, so a call is dominated by
// launch latency and by how well the scattered spans use each DRAM burst.
//
// What the design does about it: one block per span; consecutive threads
// copy consecutive 16-byte chunks of the span (vector loads from a
// 16-byte-aligned base in the source, stores to consecutive words of the
// output row), so every warp reads 512 contiguous bytes.  All element
// types are 4 bytes wide and are copied as raw 32-bit words, so the
// outputs equal the plain PyTorch gather bit for bit.  Positions are
// clamped to [0, len - 1] exactly like the XLA path of the reference
// (rag_challenge_2_tpu/ops/bm25.py:_gather_contributions), so the kernel
// is right on any CSR, with or without the build's over-allocation.  The
// TPU's 1024-element round-down and lane rolls are Mosaic tiling artefacts
// and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxArrays = 3;

struct Arrays {
  const uint32_t* src[kMaxArrays];
  uint32_t* dst[kMaxArrays];
};

__global__ void __launch_bounds__(kThreads)
    gather_spans(Arrays a, int n_arrays, const int* __restrict__ starts,
                 long long len, int window) {
  const int g = blockIdx.x;
  const long long s = starts[g];
  const long long s_end = s + window;
#pragma unroll
  for (int arr = 0; arr < kMaxArrays; ++arr) {  // static indexing: no stack
    if (arr >= n_arrays) break;
    const uint32_t* src = a.src[arr];
    uint32_t* dst = a.dst[arr] + (size_t)g * window;
    // first 16-byte-aligned source position at or before s
    const long long mis =
        ((long long)(reinterpret_cast<uintptr_t>(src) / 4) + s) & 3;
    const long long a0 = s - mis;
    const long long n_chunks = (s_end - a0 + 3) / 4;
    for (long long c = threadIdx.x; c < n_chunks; c += kThreads) {
      const long long p0 = a0 + 4 * c;
      uint32_t w[4];
      if (p0 >= 0 && p0 + 3 < len) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + p0);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          long long p = p0 + e;
          p = p < 0 ? 0 : (p >= len ? len - 1 : p);
          w[e] = src[p];
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long j = p0 + e - s;
        if (j >= 0 && j < window) dst[j] = w[e];
      }
    }
  }
}

}  // namespace

extern "C" {

// src_*: 4-byte arrays of length len (src_2 may be null); starts: i32 [G];
// dst_*: [G, window] outputs.
int rc2_span_gather(const void* src_0, const void* src_1, const void* src_2,
                    long long len, const void* starts, int G, int window,
                    void* dst_0, void* dst_1, void* dst_2, void* stream) {
  Arrays a{};
  a.src[0] = static_cast<const uint32_t*>(src_0);
  a.src[1] = static_cast<const uint32_t*>(src_1);
  a.src[2] = static_cast<const uint32_t*>(src_2);
  a.dst[0] = static_cast<uint32_t*>(dst_0);
  a.dst[1] = static_cast<uint32_t*>(dst_1);
  a.dst[2] = static_cast<uint32_t*>(dst_2);
  const int n_arrays = src_2 != nullptr ? 3 : 2;
  if (G > 0) {
    gather_spans<<<G, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        a, n_arrays, static_cast<const int*>(starts), len, window);
  }
  return (int)cudaGetLastError();
}

const char* rc2_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
