// K1: fused dense score + carried top-k for sm_90a.
//
// Replaces the TPU kernel rag_challenge_2_tpu/ops/pallas_topk.py
// (pallas_dense_topk -> _pallas_call, kernel _kernel, merge _merge_topk):
// scores Q . E^T over the corpus with a row-shared mask and keeps a
// per-query top-k on chip, so the [B, N] score matrix is never written to
// device memory.
//
// A call is two launches:
//   1. scan_float (float_scan.cuh, where its source note says what bounds
//      it and how it is laid out): a persistent grid of row chunks, the
//      store read from HBM once for all of the call's queries (B <= 64)
//      through TMA stages, scores finished in registers, and a carried
//      per-query top-k behind a register gate.  Each block writes k
//      candidates per query once.
//   2. merge_lists: one block per query cuts the blocks' lists (at most two
//      per SM) at the k-th best of their heads and ranks the few entries
//      that survive under the total order (value desc, row asc).  Ties
//      therefore go to the lowest row, exactly like a stable descending
//      sort of the masked scores.  A call whose store fits one chunk skips
//      this launch.
// Masked rows score NEG_INF (-3e38) and stay selectable after every real
// score, which reproduces the reference's overflow slots when k exceeds
// the routed rows.  What is left of the time above the store read is set
// out in the note of float_scan.cuh.

#include <cstdio>

#include "float_scan.cuh"

namespace {

constexpr int kSurvivorCap = kMaxK * kMaxK + 1;

// in: [B, n, k] lists, each sorted under (value desc, row asc); empty
// slots are (-inf, INT_MAX).  out: [B, k], k <= the rows of the store.
// One block per query, three steps:
//   1. the cut: the k-th best of the lists' heads (their first entries).
//      k heads are at least as good as it, so nothing worse than it is in
//      the top-k.  Fewer than k lists: no cut.
//   2. the survivors (entries not worse than the cut) are compacted into
//      shared memory.  Only the k - 1 lists whose heads beat the cut hold
//      any besides the cut itself: at most (k - 1) k + 1 entries, a few
//      dozen on real scores.
//   3. every survivor's rank among the survivors is counted, and ranks
//      below k are the result.  The order is total (rows are distinct), so
//      ranks are too; empty slots tie with each other only at ranks >= k.
__global__ void __launch_bounds__(kThreads)
    merge_lists(const float* __restrict__ in_v, const int* __restrict__ in_i,
                int n, int k, float* __restrict__ out_v,
                int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char msmem[];
  float* sv = reinterpret_cast<float*>(msmem);          // [cap] survivors
  int* si = reinterpret_cast<int*>(sv + kSurvivorCap);
  float* hv = reinterpret_cast<float*>(si + kSurvivorCap);   // [n] heads
  int* hi = reinterpret_cast<int*>(hv + n);
  __shared__ float cut_v;
  __shared__ int cut_r;
  __shared__ int n_surv;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t src = (size_t)b * n * k;
  if (tid == 0) {
    cut_v = -INFINITY;
    cut_r = INT_MAX;
    n_surv = 0;
  }
  for (int l = tid; l < n; l += kThreads) {
    hv[l] = in_v[src + (size_t)l * k];
    hi[l] = in_i[src + (size_t)l * k];
  }
  __syncthreads();
  if (n >= k) {
    for (int l = tid; l < n; l += kThreads) {
      const float v = hv[l];
      const int r = hi[l];
      int rank = 0;
      for (int m = 0; m < n; ++m) rank += better(hv[m], hi[m], v, r);
      if (rank == k - 1) {   // heads are distinct rows: exactly one
        cut_v = v;
        cut_r = r;
      }
    }
    __syncthreads();
  }
  const float cv = cut_v;
  const int cr = cut_r;
  for (int i = tid; i < n * k; i += kThreads) {
    const float v = in_v[src + i];
    const int r = in_i[src + i];
    if (r != INT_MAX && !better(cv, cr, v, r)) {
      const int slot = atomicAdd(&n_surv, 1);
      sv[slot] = v;
      si[slot] = r;
    }
  }
  __syncthreads();
  const int S = n_surv;
  for (int i = tid; i < S; i += kThreads) {
    const float v = sv[i];
    const int r = si[i];
    int rank = 0;
    for (int m = 0; m < S; ++m) rank += better(sv[m], si[m], v, r);
    if (rank < k) {
      out_v[(size_t)b * k + rank] = v;
      out_i[(size_t)b * k + rank] = r;
    }
  }
}

}  // namespace

extern "C" {

// The planner's constants (see float_scan_constants).
int rc2_dense_topk_constants(int* out, int n) { return float_scan_constants(out, n); }

// The stage count the library gives a tile, or < 2 when it does not fit.
int rc2_dense_topk_stages(int query_tile, int warp_queries, int tile_rows, int emb_bf16,
                          int k,
                          int blocks_per_sm) {
  return float_scan_stages(query_tile, warp_queries, tile_rows, emb_bf16 ? 2 : 4, k,
                           blocks_per_sm);
}

// q: f32 [B, D]; emb: f32 or bf16 [N, D] row-major; mask: u8 [N] or null.
// The grid is n_chunks blocks of rows_per_chunk rows in tiles of the
// query_tile's layout, box_rows rows per stage; cand_v / cand_i:
// scratch of B * n_chunks * k entries (unused when n_chunks is 1);
// out: [B, k].
int rc2_dense_topk(const void* q, const void* emb, int emb_bf16,
                   const void* mask, int B, int N, int D, int k, int query_tile,
                   int rows_per_chunk, int n_chunks, int box_rows, int blocks_per_sm,
                   void* cand_v, void* cand_i, void* out_v,
                   void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || k > N || B < 1 || D < 1 || n_chunks < 1 ||
      (long long)n_chunks * rows_per_chunk < N)
    return (int)cudaErrorInvalidValue;
  const bool one = n_chunks == 1;   // the only block's list is the result
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
  p.cand_v = static_cast<float*>(one ? out_v : cand_v);
  p.cand_i = static_cast<int*>(one ? out_i : cand_i);
  int rc = launch_scan_float<true>(p, emb_bf16 != 0, query_tile, n_chunks, blocks_per_sm, s);
  if (rc != 0 || one) return rc;
  const int msmem = (kSurvivorCap + n_chunks) * (int)(sizeof(float) + sizeof(int));
  if (msmem > kDefaultDynamicSmem) {   // only a grid of more than 2,047 blocks
    cudaError_t e = cudaFuncSetAttribute(
        merge_lists, cudaFuncAttributeMaxDynamicSharedMemorySize, msmem);
    if (e != cudaSuccess) return (int)e;
  }
  merge_lists<<<B, kThreads, msmem, s>>>(p.cand_v, p.cand_i, n_chunks, k,
                                         static_cast<float*>(out_v),
                                         static_cast<int*>(out_i));
  return (int)cudaGetLastError();
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
