// mbarrier helpers shared by the kernels that stage their loads through the
// Tensor Memory Accelerator: scan_float (float_scan.cuh, K1 and K3's f32 /
// bf16 forms), scan_i8 (stream_topk.cu) and the TMA form of the span gather
// kept for comparison (scripts/k2_tma.cu).
//
// Every wait on a stage is bounded: a transfer that never completes traps
// after kStageWaitNs instead of hanging the card.

#pragma once

#include <stdint.h>

namespace {

constexpr uint64_t kStageWaitNs = 4000000000ull;   // 4 s: a stuck stage traps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for a ring stage.  A stage that never completes (a transfer whose
// bytes do not match the expected count, a tensor map that does not fit
// the call) would spin forever and hang the card, so after kStageWaitNs
// the block traps: the launch fails, and the caller's next synchronisation
// raises.  A healthy stage arrives within microseconds.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t t = global_ns();
    if (t0 == 0) {
      t0 = t;
    } else if (t - t0 > kStageWaitNs) {
      __trap();
    }
  }
}

}  // namespace
