// Bulk copies (TMA), mbarriers and the cross-block ticket, shared by the
// port's kernels (csrc/fused_auxiva_ip.cu, csrc/weighted_covariance.cu).
// ops/_build.py hashes this header with each source, so an edit rebuilds
// both libraries.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A barrier whose phases each complete after `arrivals` arrivals and the
// bytes they expect.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned arrivals = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The one arrival of the barrier's current phase, expecting `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Expect `bytes` more of copies in the current phase, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// One arrival on the current phase (release: the caller's shared-memory
// accesses before it are ordered before whatever follows the phase's wait).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of this parity has completed (acquire: the
// copied bytes are then visible to the calling thread).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Order this thread's earlier generic-proxy accesses of shared memory before
// its later bulk copies into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ uintptr_t up16(uintptr_t p) { return (p + 15) & ~uintptr_t(15); }
__device__ __forceinline__ uintptr_t down16(uintptr_t p) { return p & ~uintptr_t(15); }

// ---- the cross-block reduction ---------------------------------------------

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// Every thread has written its share; take a ticket.  Returns true in every
// thread of the block that arrives last of `count`, which resets the ticket
// and may then read what the others wrote.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket, unsigned count, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel_gpu();
    const bool last = atomicAdd(ticket, 1u) == count - 1;
    if (last) {
      *ticket = 0;
      fence_acq_rel_gpu();
    }
    *flag = last;
  }
  __syncthreads();
  return *flag;
}

}  // namespace hopper
