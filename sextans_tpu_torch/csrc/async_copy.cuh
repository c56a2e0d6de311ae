// async_copy.cuh: copies from device memory into shared memory that run
// beside the threads' own work, for the skinny slab kernel (K2,
// spmm_slab.cu), the wide DIA kernel (K6, spmm_dia.cu) and the SDDMM
// (sddmm.cu). sm_90 PTX:
//
// * cp.async.bulk (the Tensor Memory Accelerator's 1-D copy): one thread
//   asks for a contiguous run of bytes; its completion is counted in bytes
//   on an mbarrier in shared memory, whose phase completes once every
//   expected byte has landed and every expected thread has arrived. Source,
//   destination and size must be multiples of 16 bytes.
// * cp.async (4 or 16 bytes a thread): the per-thread copy, for what is not
//   16-byte aligned. Completed either by cp.async.wait_group, or by
//   cp.async.mbarrier.arrive.noinc, which makes the mbarrier count one
//   arrival of this thread once its earlier cp.async copies have landed.
//
// The copies write shared memory through the async proxy; the mbarrier
// wait (or wait_group and a __syncthreads) makes them visible to the
// threads' loads. A stage is overwritten only after a __syncthreads that
// follows every thread's last read of it.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace sx_async {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier whose phases each complete after `count` arrivals (and the
// bytes its arrivals announced).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised mbarriers visible to the async proxy; follow with
// __syncthreads() before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces `bytes` more to come by bulk copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from src to dst, both 16-byte aligned,
// counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The same, copying `src_bytes` (4 or 0) of the 4 and filling the rest of
// `dst` with zeros: src_bytes 0 reads nothing.
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 16 bytes, of which `src_bytes` (16 or 0) are copied and the rest zeroed.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// This thread's arrival on `bar`, made once its cp.async copies have landed
// (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait for all of this thread's cp.async copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// Close this thread's group of cp.async copies issued since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace sx_async
