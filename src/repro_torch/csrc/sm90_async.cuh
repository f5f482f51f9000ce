// Hopper primitives shared by the persistent and streaming kernels: mbarriers
// in shared memory, 1-D bulk asynchronous copies (TMA) that complete on them,
// 4-byte cp.async copies for rows that are not 16-byte aligned, the proxy
// fence between ordinary stores and bulk copies, and the group barrier of
// the cooperative block-chain kernels.
//
// Used by K7 (`swa_decode.cu`: a ring of bulk copies under full/empty
// mbarriers), K3 (`sgns_row_grads.cu`: the same ring, with 4-byte copies for
// spans that are not 16-byte aligned), K5 and K6 (`sgns_pipe.cuh`: the
// group barrier) and K2 and K4a (`sgns_block_step.cuh`: all of them).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sm90 {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One float from global to this thread's shared memory, asynchronously
// (cp.async; complete after the thread's commit group is waited for).
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One arrival on `bar`, made when every cp.async this thread has issued so
// far has landed (counts against the barrier's expected arrivals).
__device__ __forceinline__ void copy_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until at most N of this thread's newest commit groups are pending.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Orders this thread's earlier ordinary memory operations before its later
// bulk copies (the async proxy), and the other way round.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// Every CTA of a group arrives, then waits for the group's `target`-th
// arrival. The fences order the CTA's writes before its arrival and its
// later reads after the others' arrivals.
__device__ __forceinline__ void group_barrier(int* counter, int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;" : : "l"(counter) : "memory");
    int seen = 0;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

}  // namespace sm90
