// Hopper's asynchronous copies and the mbarriers that track them, sm_90a:
// shared by the GEMM body of B3/B4/B5 (wq_gemm_sm90.cuh) and the T=1
// attention body of B1/B3 (t1_attention.cuh).
//
// A barrier is initialised by one thread (bar_init, then
// fence.mbarrier_init), armed with the bytes a phase expects (bar_expect),
// and completes when they have landed; bar_wait spins on the phase's
// parity. Copies: TMA boxes of a tensor map (tma_2d), one-dimensional bulk
// copies that need no map (bulk_copy: size a multiple of 16 bytes, both
// addresses 16-byte aligned), and 4- or 8-byte cp.async whose arrival is
// counted on a barrier (cp_async_arrive). Cluster helpers read another
// block's shared memory (distributed shared memory).

#pragma once

#include <cuda.h>  // CUtensorMap (types only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

// makes barriers initialised by this thread visible to the async proxy
// (and to the cluster); the block synchronises after it
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// waits for the completion of the barrier's phase of this parity; a wait
// past ~10 s of clock (a pipeline that can never complete) traps, so a
// fault in the ring ends the launch with an error instead of hanging it
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}

// a 4-byte copy global -> shared that reads nothing and stores 0 when
// !valid, and the arrival on `b` once this thread's copies have landed
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

// one 2-D box of a tensor map into shared memory; c0 is the column
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes global -> shared (the one-dimensional TMA),
// completing on `bar`; bytes % 16 == 0, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// orders this thread's generic-proxy accesses of shared memory before
// later async-proxy ones (a bulk copy or wgmma into / from the same bytes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- thread block clusters ---------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster arrives and waits; shared
// memory written before it is visible to the cluster after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the f32 at `p` (this block's shared address) in block `rank`'s copy
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

}  // namespace hopper
