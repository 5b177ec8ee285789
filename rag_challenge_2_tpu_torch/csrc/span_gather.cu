// K2: posting-span gather for sm_90a.
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
// n_arrays x G x window x 4 bytes written: 1-25 MB at the main path's
// shapes, microseconds at 3.35 TB/s.  So a launch is as long as its chain
// of dependent memory round trips and its waves of blocks.  The kernel it
// replaced (one block per span, a load then a store per 16-byte chunk,
// array after array) made that chain n_arrays x ceil(window / 512) long: 6
// at window 512 with doc lengths, 24 at 4096.
//
// What the design does about it: all of a piece's loads are in flight at
// once, then realigned in registers.
//   * a work item is one piece of one span, at most kMaxPiece output words
//     (a 4096-word span is two items, a 512-word span one) and one block;
//     a span's pieces are neighbouring blocks, so they run side by side
//     over contiguous memory.  ops/span_gather.plan makes the cut and
//     picks the chunks a thread holds, so a short piece keeps few registers
//     and more blocks fit an SM.
//   * each thread first issues every load it needs for every array: the
//     two 16-byte-aligned source chunks under each 16-byte chunk of the
//     output row it writes (aligned from the element address, so views such
//     as ids[1:] stay right), and the words before the row's first 16-byte
//     boundary and after its last.  Only then does it store: the window is
//     shifted by a select on a per-array uniform offset and written as
//     uint4, the few edge words as 4-byte stores.  A span costs one start
//     read and one round of loads.
//   * a piece whose aligned extension leaves [0, len) in any array is
//     copied word by word with clamped positions.  A real index never
//     reaches this path (the build over-allocates by dma_slack); it exists
//     so the kernel is right on any CSR.
// A TMA form of the same idea (one bulk copy per array and piece into a
// ring of shared-memory stages, scripts/k2_tma.cu) was measured beside this
// one by scripts/k2_sweep.py: it lost in warm trains (PERF.md).
// The TPU's 1024-element round-down and lane rolls are Mosaic tiling
// artefacts and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// mirrored in ops/span_gather.py (SPAN_CONSTANTS); a card test holds both equal
constexpr int kThreads = 128;
constexpr int kMaxArrays = 3;
constexpr int kMaxPiece = 2048;                       // output words of one item
constexpr int kMaxChunks = kMaxPiece / 4 / kThreads;  // 16-byte chunks a thread holds

struct Arrays {
  const uint32_t* src[kMaxArrays];
  uint32_t* dst[kMaxArrays];
};

__device__ __forceinline__ long long word_addr(const void* p) {
  return (long long)(reinterpret_cast<uintptr_t>(p) >> 2);
}

// The 4 words that start r words into lo, running on into hi.
__device__ __forceinline__ uint4 shifted(uint4 lo, uint4 hi, int r) {
  switch (r) {
    case 0: return lo;
    case 1: return make_uint4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_uint4(lo.z, lo.w, hi.x, hi.y);
    default: return make_uint4(lo.w, hi.x, hi.y, hi.z);
  }
}

// NA arrays; a thread holds up to KC output chunks per array.
template <int NA, int KC>
__global__ void __launch_bounds__(kThreads)
    gather_spans(Arrays a, const int* __restrict__ starts, long long len, int window,
                 int piece, int n_pieces) {
  const int t = threadIdx.x;
  // block = span * n_pieces + piece: a span's pieces run side by side
  const int span = n_pieces == 1 ? (int)blockIdx.x : (int)blockIdx.x / n_pieces;
  const int pc = (int)blockIdx.x - span * n_pieces;
  const long long p0 = (long long)__ldg(starts + span) + (long long)pc * piece;
  const int n = min(piece, window - pc * piece);
  const size_t row = (size_t)span * window + (size_t)pc * piece;

  // a piece whose aligned extension leaves [0, len) in any array is copied
  // word by word, clamped
  bool edge = false;
#pragma unroll
  for (int arr = 0; arr < NA; ++arr) {
    const long long aw = word_addr(a.src[arr]);
    const long long end = p0 + n;
    edge |= p0 - ((aw + p0) & 3) < 0 || end + ((-(aw + end)) & 3) > len;
  }
  if (edge) {
#pragma unroll
    for (int arr = 0; arr < NA; ++arr) {
      uint32_t* dst = a.dst[arr] + row;
      for (int j = t; j < n; j += kThreads) {
        long long p = p0 + j;
        p = p < 0 ? 0 : (p >= len ? len - 1 : p);
        dst[j] = a.src[arr][p];
      }
    }
    return;
  }

  uint4 lo[NA][KC], hi[NA][KC];
  uint32_t head_w[NA], tail_w[NA];
  int head[NA], nb[NA], r[NA];
  // every load of every array first
#pragma unroll
  for (int arr = 0; arr < NA; ++arr) {
    const uint32_t* src = a.src[arr];
    const int mis = (int)((word_addr(src) + p0) & 3);
    head[arr] = min(n, (int)((4 - (word_addr(a.dst[arr] + row) & 3)) & 3));
    nb[arr] = (n - head[arr]) >> 2;
    const int sh = mis + head[arr];
    r[arr] = sh & 3;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + (p0 - mis)) + (sh >> 2);
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int c = t + i * kThreads;
      if (c < nb[arr]) {
        lo[arr][i] = __ldg(s4 + c);
        if (r[arr]) hi[arr][i] = __ldg(s4 + c + 1);
      }
    }
    if (t < head[arr]) head_w[arr] = __ldg(src + p0 + t);
    const int tj = head[arr] + 4 * nb[arr] + t;
    if (tj < n) tail_w[arr] = __ldg(src + p0 + tj);
  }
  // then every store
#pragma unroll
  for (int arr = 0; arr < NA; ++arr) {
    uint32_t* dst = a.dst[arr] + row;
    if (t < head[arr]) dst[t] = head_w[arr];
    uint4* d4 = reinterpret_cast<uint4*>(dst + head[arr]);
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int c = t + i * kThreads;
      if (c < nb[arr]) d4[c] = shifted(lo[arr][i], hi[arr][i], r[arr]);
    }
    const int tj = head[arr] + 4 * nb[arr] + t;
    if (tj < n) dst[tj] = tail_w[arr];
  }
}

template <int NA>
cudaError_t launch(const Arrays& a, const int* starts, long long len, int G, int window,
                   int piece, int n_pieces, int chunks, cudaStream_t stream) {
  const unsigned grid = (unsigned)G * (unsigned)n_pieces;
  switch (chunks) {
    case 1:
      gather_spans<NA, 1><<<grid, kThreads, 0, stream>>>(a, starts, len, window, piece, n_pieces);
      break;
    case 2:
      gather_spans<NA, 2><<<grid, kThreads, 0, stream>>>(a, starts, len, window, piece, n_pieces);
      break;
    default:
      gather_spans<NA, kMaxChunks><<<grid, kThreads, 0, stream>>>(a, starts, len, window, piece,
                                                                   n_pieces);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src_*: 4-byte arrays of length len (src_2 may be null); starts: i32 [G];
// dst_*: [G, window] outputs.  piece, n_pieces and chunks (16-byte output
// chunks a thread holds per array: 1, 2 or 4) are the planner's
// (ops/span_gather.py: plan).
int rc2_span_gather(const void* src_0, const void* src_1, const void* src_2,
                    long long len, const void* starts, int G, int window,
                    void* dst_0, void* dst_1, void* dst_2, int piece, int n_pieces,
                    int chunks, void* stream) {
  Arrays a{};
  a.src[0] = static_cast<const uint32_t*>(src_0);
  a.src[1] = static_cast<const uint32_t*>(src_1);
  a.src[2] = static_cast<const uint32_t*>(src_2);
  a.dst[0] = static_cast<uint32_t*>(dst_0);
  a.dst[1] = static_cast<uint32_t*>(dst_1);
  a.dst[2] = static_cast<uint32_t*>(dst_2);
  if (G <= 0) return 0;
  if (window < 1 || len < 1 || piece < 1 || piece > kMaxPiece || n_pieces < 1
      || (long long)G * n_pieces > 2147483647LL || (long long)(n_pieces - 1) * piece >= window
      || (long long)n_pieces * piece < window || (chunks != 1 && chunks != 2 && chunks != 4)
      || (piece + 3) / 4 > chunks * kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int* st = static_cast<const int*>(starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = src_2 != nullptr
                            ? launch<3>(a, st, len, G, window, piece, n_pieces, chunks, s)
                            : launch<2>(a, st, len, G, window, piece, n_pieces, chunks, s);
  return (int)e;
}

// The constants the planner mirrors, for the card test that holds them equal.
void rc2_span_gather_constants(int* out) {
  out[0] = kThreads;
  out[1] = kMaxArrays;
  out[2] = kMaxPiece;
  out[3] = kMaxChunks;
}

const char* rc2_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
