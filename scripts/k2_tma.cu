// K2: posting-span gather for sm_90a, TMA form (an experiment).
//
// Replaces the TPU kernel rag_challenge_2_tpu/ops/pallas_bm25.py
// (gather_posting_spans): for G start offsets, copy the window-wide
// contiguous spans [start, start + window) of two or three parallel flat
// arrays of 4-byte words (the CSR's i32 chunk ids, f32 term frequencies and
// optional f32 per-posting doc lengths; the IVF's row ids and row scales)
// into one [n_arrays, G, window] buffer.  Positions are clamped to
// [0, len - 1] exactly like the XLA path of the reference
// (rag_challenge_2_tpu/ops/bm25.py:_gather_contributions), and words are
// copied as raw 32-bit values, so the outputs equal the plain PyTorch
// gather bit for bit on any CSR, with or without the build's slack.
//
// What bounds it on the H100: bytes.  It does no arithmetic; the least it
// must move is each distinct span word read once (the 8 expanded queries of
// a request share most of their terms, the IVF's probed lists overlap) and
// n_arrays x G x window x 4 bytes written.  At the main path's shapes that
// is 1-25 MB, microseconds at 3.35 TB/s, so a launch is as long as its
// chain of dependent DRAM round trips.  One block per span, looping over
// 16-byte chunks array after array with a load then a store in each pass,
// made that chain n_arrays x ceil(window / 512) long (6 at window 512 with
// doc lengths, 24 at 4096).
//
// The TMA form of K2, measured against the shipped register-staged kernel
// (rag_challenge_2_tpu_torch/csrc/span_gather.cu) by scripts/k2_sweep.py
// and kept only for that comparison; the port never calls it.  Same
// contract, same edge path, same realigned 16-byte writes; the loads differ:
//   * a persistent grid: each block walks work items (span, piece), as
//     scripts/k2_sweep.py's tma_plan cuts them (one item per block where
//     the items fit up to 8 blocks an SM, else a ring of up to 4 stages);
//   * for each item one thread issues a 1-D TMA bulk copy global -> shared
//     per array, of the 16-byte-aligned extension of the piece, completing
//     on the stage's mbarrier; the next item's start is read a round ahead;
//     a stage that has not arrived after 4 s traps (tma.cuh);
//   * the threads write the shifted window out of shared memory.
// On NVIDIA H100 80GB HBM3 (700 W) it is faster than the kernel it replaced
// with L2 cold and slower in warm trains (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "../rag_challenge_2_tpu_torch/csrc/tma.cuh"

namespace {

// The barrier's one arrival with no transfer: completes a stage that the
// threads fill by the word path.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One 1-D bulk copy global -> shared by the TMA, completing on `bar`:
// `bytes` a multiple of 16, both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

constexpr int kThreads = 128;
constexpr int kMaxArrays = 3;
constexpr int kMaxStages = 4;
constexpr int kMaxPiece = 2048;           // output words of one work item
constexpr int kSmemBlockMax = 232448;     // 227 KB
constexpr int kMaxDevices = 64;           // devices whose attributes are remembered

struct Arrays {
  const uint32_t* src[kMaxArrays];
  uint32_t* dst[kMaxArrays];
};

struct Geometry {
  int G, window, piece, n_pieces, stage_words, stages;
  long long len;
};

// A stage's layout in dynamic shared memory: the stages' words first (all
// 16-byte aligned: stage_words is a multiple of 4), then per stage its
// mbarrier, the piece's first position and whether it is an edge piece.
struct Smem {
  uint32_t* words;
  uint64_t* bars;
  long long* p0;
  int* edge;
};

__device__ __forceinline__ Smem carve(unsigned char* smem, const Geometry& g, int n_arrays) {
  Smem s;
  s.words = reinterpret_cast<uint32_t*>(smem);
  unsigned char* tail = smem + (size_t)g.stages * n_arrays * g.stage_words * 4;
  s.bars = reinterpret_cast<uint64_t*>(tail);
  s.p0 = reinterpret_cast<long long*>(tail + kMaxStages * 8);
  s.edge = reinterpret_cast<int*>(tail + 2 * kMaxStages * 8);
  return s;
}

__device__ __forceinline__ long long word_addr(const void* p) {
  return (long long)(reinterpret_cast<uintptr_t>(p) >> 2);
}

// Starts the loads of the block's k-th item into `slot`: one bulk copy per
// array, or, for an edge piece, a plain arrival.  `s` is the span's start.
__device__ __forceinline__ void issue(const Arrays& a, int n_arrays, const Geometry& g,
                                      const Smem& sm, int item, long long s, int slot) {
  const int pc = item % g.n_pieces;
  const long long p0 = s + (long long)pc * g.piece;
  const int n = min(g.piece, g.window - pc * g.piece);
  long long a0[kMaxArrays];
  uint32_t nbytes[kMaxArrays];
  bool edge = false;
  uint32_t total = 0;
#pragma unroll
  for (int arr = 0; arr < kMaxArrays; ++arr) {
    if (arr >= n_arrays) break;
    const long long aw = word_addr(a.src[arr]);
    const long long lo = p0 - ((aw + p0) & 3);
    long long hi = p0 + n;
    hi += (-(aw + hi)) & 3;
    edge |= lo < 0 || hi > g.len;
    a0[arr] = lo;
    nbytes[arr] = (uint32_t)(hi - lo) * 4u;
    total += nbytes[arr];
  }
  sm.p0[slot] = p0;
  sm.edge[slot] = edge;
  const uint32_t bar = smem_u32(sm.bars + slot);
  if (edge) {
    mbar_arrive(bar);
    return;
  }
  mbar_expect_tx(bar, total);
  uint32_t* st = sm.words + (size_t)slot * n_arrays * g.stage_words;
#pragma unroll
  for (int arr = 0; arr < kMaxArrays; ++arr) {
    if (arr >= n_arrays) break;
    bulk_g2s(smem_u32(st + arr * g.stage_words), a.src[arr] + a0[arr], nbytes[arr], bar);
  }
}

// 16-byte chunk c of a window that starts R words into 16-byte chunk 0.
template <int R>
__device__ __forceinline__ uint4 shifted(const uint4* s4, int c) {
  if constexpr (R == 0) {
    return s4[c];
  } else {
    const uint4 lo = s4[c], hi = s4[c + 1];
    if constexpr (R == 1) return make_uint4(lo.y, lo.z, lo.w, hi.x);
    if constexpr (R == 2) return make_uint4(lo.z, lo.w, hi.x, hi.y);
    return make_uint4(lo.w, hi.x, hi.y, hi.z);
  }
}

template <int R>
__device__ __forceinline__ void write_body(const uint4* s4, uint4* d4, int nb) {
#pragma unroll 4
  for (int c = threadIdx.x; c < nb; c += kThreads) d4[c] = shifted<R>(s4, c);
}

// Writes the piece's n words from the stage (its window starts `mis` words
// into the copied extension) to dst: 4-byte stores up to the row's first
// 16-byte boundary, 16-byte stores after it, 4-byte stores for the rest.
__device__ __forceinline__ void write_piece(const uint32_t* w, int mis, uint32_t* dst, int n) {
  const int head = min(n, (int)((4 - (word_addr(dst) & 3)) & 3));
  if ((int)threadIdx.x < head) dst[threadIdx.x] = w[mis + threadIdx.x];
  const int nb = (n - head) >> 2;
  const int sh = mis + head;
  const uint4* s4 = reinterpret_cast<const uint4*>(w) + (sh >> 2);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  switch (sh & 3) {
    case 0: write_body<0>(s4, d4, nb); break;
    case 1: write_body<1>(s4, d4, nb); break;
    case 2: write_body<2>(s4, d4, nb); break;
    default: write_body<3>(s4, d4, nb); break;
  }
  for (int j = head + 4 * nb + threadIdx.x; j < n; j += kThreads) dst[j] = w[mis + j];
}

__global__ void __launch_bounds__(kThreads)
    gather_spans(Arrays a, int n_arrays, const int* __restrict__ starts, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, g, n_arrays);
  const int items = g.G * g.n_pieces;
  if ((int)blockIdx.x >= items) return;
  const int n_my = (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int S = g.stages;

  // thread `slot` < S issues the slot's items k = slot, slot + S, ...; it
  // holds the start of the slot's next item in `next`, read a round ahead.
  // The first starts are read before the barriers are set up, so that
  // read's latency overlaps the set-up.
  auto item_of = [&](int k) { return (int)blockIdx.x + k * (int)gridDim.x; };
  auto start_of = [&](int k) {
    return k < n_my ? (long long)starts[item_of(k) / g.n_pieces] : 0ll;
  };
  const bool issuer = (int)threadIdx.x < S && (int)threadIdx.x < n_my;
  long long first = 0, next = 0;
  if (issuer) {
    first = start_of(threadIdx.x);
    next = start_of(threadIdx.x + S);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(sm.bars + s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (issuer) issue(a, n_arrays, g, sm, item_of(threadIdx.x), first, threadIdx.x);

  for (int k = 0; k < n_my; ++k) {
    const int slot = k % S;
    mbar_wait(smem_u32(sm.bars + slot), (k / S) & 1);
    const int item = item_of(k);
    const int span = item / g.n_pieces;
    const int pc = item % g.n_pieces;
    const long long p0 = sm.p0[slot];
    const bool edge = sm.edge[slot] != 0;
    const int n = min(g.piece, g.window - pc * g.piece);
    const uint32_t* st = sm.words + (size_t)slot * n_arrays * g.stage_words;
#pragma unroll
    for (int arr = 0; arr < kMaxArrays; ++arr) {
      if (arr >= n_arrays) break;
      uint32_t* dst = a.dst[arr] + (size_t)span * g.window + (size_t)pc * g.piece;
      if (edge) {
        const uint32_t* src = a.src[arr];
        for (int j = threadIdx.x; j < n; j += kThreads) {
          long long p = p0 + j;
          p = p < 0 ? 0 : (p >= g.len ? g.len - 1 : p);
          dst[j] = src[p];
        }
      } else {
        const int mis = (int)((word_addr(a.src[arr]) + p0) & 3);
        write_piece(st + arr * g.stage_words, mis, dst, n);
      }
    }
    __syncthreads();   // the stage is read: it may be refilled
    if ((int)threadIdx.x == slot && k + S < n_my) {
      const long long s = next;
      next = start_of(k + 2 * S);
      issue(a, n_arrays, g, sm, item_of(k + S), s, slot);
    }
  }
}

}  // namespace

extern "C" {

// src_*: 4-byte arrays of length len (src_2 may be null); starts: i32 [G];
// dst_*: [G, window] outputs.  The geometry (piece, n_pieces, stage_words,
// stages, grid, smem_bytes) is scripts/k2_sweep.py's tma_plan.
int rc2_span_gather(const void* src_0, const void* src_1, const void* src_2,
                    long long len, const void* starts, int G, int window,
                    void* dst_0, void* dst_1, void* dst_2, int piece, int n_pieces,
                    int stage_words, int stages, int grid, int smem_bytes,
                    void* stream) {
  Arrays a{};
  a.src[0] = static_cast<const uint32_t*>(src_0);
  a.src[1] = static_cast<const uint32_t*>(src_1);
  a.src[2] = static_cast<const uint32_t*>(src_2);
  a.dst[0] = static_cast<uint32_t*>(dst_0);
  a.dst[1] = static_cast<uint32_t*>(dst_1);
  a.dst[2] = static_cast<uint32_t*>(dst_2);
  const int n_arrays = src_2 != nullptr ? 3 : 2;
  if (G <= 0) return 0;
  if (window < 1 || len < 1 || piece < 1 || piece > kMaxPiece || n_pieces < 1
      || (long long)(n_pieces - 1) * piece >= window || (long long)n_pieces * piece < window
      || stage_words % 4 != 0 || stage_words < (piece + 3) / 4 * 4 + 8
      || stages < 1 || stages > kMaxStages || grid < 1
      || (long long)grid > (long long)G * n_pieces || smem_bytes > kSmemBlockMax
      || (long long)smem_bytes
             < (long long)stages * n_arrays * stage_words * 4 + 2 * kMaxStages * 8
                   + kMaxStages * 4) {
    return (int)cudaErrorInvalidValue;
  }
  // the shared-memory limit is raised once per device
  static bool smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= kMaxDevices || !smem_set[device]) {
    e = cudaFuncSetAttribute(gather_spans, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBlockMax);
    if (e != cudaSuccess) return (int)e;
    if (device < kMaxDevices) smem_set[device] = true;
  }
  const Geometry g{G, window, piece, n_pieces, stage_words, stages, len};
  gather_spans<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      a, n_arrays, static_cast<const int*>(starts), g);
  return (int)cudaGetLastError();
}

const char* rc2_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
