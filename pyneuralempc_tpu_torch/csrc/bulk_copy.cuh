// Hopper's asynchronous copies into shared memory (sm_90a), each inline-PTX
// primitive in one small __device__ function: the 1-D bulk copy (the Tensor
// Memory Accelerator's copy of a contiguous range) that completes on an
// mbarrier, the mbarrier's init, arrival and wait, and the 4-, 8- and
// 16-byte cp.async copies for ranges the bulk copy does not take, with the
// wait on their groups; and the
// clocks a kernel's phases are stamped with.  Keeping them here, and
// nothing else, lets a host-side emulation of a kernel replace this header
// with plain copies and host clocks.

#pragma once

#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Initialise the mbarrier `bar` (8 bytes of shared memory) for one arrival
// and make the initialisation visible to the copy engine.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The barrier's one arrival, announcing `bytes` of copies that complete on
// it.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spin until the barrier's phase `parity` (0 for its first) has completed:
// the arrival made and every announced byte landed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One bulk copy of `bytes` from global to shared memory, completing on
// `bar`.  Both addresses 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One float from global to shared memory by cp.async; it has landed after
// the calling thread's next copy4_wait_all().
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

// Two floats by cp.async (both addresses 8-byte aligned), and four (both
// 16-byte aligned, L1 bypassed: the stage inputs are read once); either
// lands as the 4-byte copy does, at the calling thread's wait on its group.
__device__ __forceinline__ void copy8_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// Wait until at most N of the calling thread's committed cp.async groups
// are still in flight.  N is an immediate of the instruction, so a ring's
// depth, a template argument, sets it at any depth.
template <int N>
__device__ __forceinline__ void copy_wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void copy4_wait_all() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// The SM's cycle counter and the device's nanosecond clock (%globaltimer,
// one clock for every SM), for stamping a kernel's phases.
__device__ __forceinline__ void read_clocks(long long* cycles,
                                            long long* ns) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  *cycles = clock64();
  *ns = static_cast<long long>(t);
}

}  // namespace
