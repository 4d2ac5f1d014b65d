// The large-M form of kernels B4 (q8_matmul.cu, Q8_0) and B5 (q4_matmul.cu,
// Q4_0) with bf16 activations, sm_90a: the calls of many rows, M = B x
// chunk_len in the ticks at right context 1 / 6 / 13 (512 to 3,584 at
// B=256) and M = B x T' on the offline path (769 to 16,384). Below the
// crossover of ops/quant.py:gemm_plan the calls run wq_gemm_sm90.cuh's
// gemm_sm90 (the form of the R=0 tick's M <= 256), unchanged.
//
//     y[m, n] = bf16( sum_k x[m, k] * bf16(code(n, k) * scale[n, k / 32]) )
//
// The rounding points are gemm_sm90's and the plain versions'
// (ops/quant.py): each weight rounded once to bf16 from its f32 product, f32
// sums, one bf16 rounding of the sum.
//
// What bounds it on the H100: the operations. At M = 16,384 and (N, K) =
// (4096, 1024) a call does 2*M*N*K = 137 GFLOP (0.139 ms at 989 TFLOP/s)
// and must move 172 MB (0.052 ms at 3.35 TB/s: the codes, scales and x
// once, y once). gemm_sm90 gives each block 128 weight rows x <= 128
// streams, so there each code tile is read and dequantized once per 128
// rows of the batch (128 times), each x tile read once per 128 weight rows
// (32 times), and within a warpgroup each step's dequantization and wgmma
// run one after the other: 0.25 of the bound (PERF.md).
//
// Design: two launches, both written here.
//   * dequant_bf16 writes the layer's weight once as bf16, [N, K] row-major,
//     into scratch that the wrapper allocates (8 MB for 4M weights: ~4 us
//     of bytes against a 52-139 us bound at M >= 6,152). Each code is
//     dequantized once per call.
//   * gemm_large is a dense bf16 GEMM y = x . W^T on wgmma: persistent
//     blocks, one per SM, walk the output's 128 x BN tiles (BN = 256, or
//     128 where the 256-wide tiles leave SMs idle; the plan picks it) in
//     row-major order, x row tiles outermost, so the blocks in flight
//     share a few x row tiles and the whole weight in L2. Warp-specialised:
//     one producer warpgroup (one thread issues TMA for the x tile [128,
//     64] and the weight tile [BN, 64], 128-byte swizzle, into a ring of
//     up to kMaxStages stages with a full and an empty mbarrier each) runs
//     ahead across tile boundaries; two consumer warpgroups each run
//     m64nBNk16 wgmma with both operands in shared memory on 64 of the
//     tile's x rows, keep one step's wgmma in flight while the next is
//     issued (wait group 1), and hand each stage back as soon as its
//     wgmma retired. Nothing is dequantized on the wgmma's critical path.
//     The epilogue rounds the accumulators to bf16 into a staging tile
//     (stmatrix, 128-byte swizzle) that TMA stores into y (whole lines;
//     ragged M and N clipped by the map) while the consumers go on to the
//     next tile, whose stages the producer has already filled.
//   * No atomics and no split-K: each output is one f32 sum in a fixed
//     order, rounded once, so results repeat bit for bit. No host sync and
//     no allocation: the launcher builds three tensor maps and launches.
// What holds it back (tools/gemm_turns.py --probe=large, PERF.md): each
// tile's x and weight tiles come from L2 once per tile (at 16,384 x
// (4096, 1024) ~1.6 GB a call), and the staging tile leaves room for 3
// stages at BN = 256. Clusters of two blocks multicasting the shared
// weight tile measured 1.6-2.0x slower in this design and are left out.
// Shapes: K % 32 == 0 (K % 64 for Q4_0), N % 8 == 0, x and y 16-byte
// aligned (the wrappers and the plan check).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"
#include "smem_limit.cuh"
#include "wq_gemm_sm90.cuh"  // desc_sw128, fence_acc, map_2d, encoder

namespace wq {
namespace large {

constexpr int kBM = 128;       // x rows per tile: 2 consumer warpgroups x 64
constexpr int kBK = 64;        // K columns per step: one 128-byte bf16 row
constexpr int kThreads = 384;  // 2 consumer warpgroups + 1 producer
// the ring holds as many stages as the device's shared memory per block
// allows, up to this many (on the H100: 3 at BN = 256, 6 at BN = 128)
constexpr int kMaxStages = 8;
// measurement only (tools/gemm_turns.py --probe builds these variants):
// bit 1 leaves out the epilogue's staging and stores, bit 2 the wgmma; 0
// in every build of the kernels
#ifndef WQ_LARGE_PROBE
#define WQ_LARGE_PROBE 0
#endif
constexpr int kProbe = WQ_LARGE_PROBE;

__host__ __device__ inline int stage_bytes(int bn) { return (kBM + bn) * 128; }

// alignment slack + the ring + the epilogue's staging of the 128 x bn bf16
// tile + the ring's two mbarriers per stage
__host__ __device__ inline int smem_bytes(int bn, int stages) {
  return 1024 + stages * stage_bytes(bn) + kBM * bn * 2 + 2 * stages * 8;
}

// the most stages (2 to kMaxStages) whose shared memory the current device
// grants one block; 0 where two do not fit
inline int ring_stages(int bn) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  int stages = kMaxStages;
  while (stages >= 2 && smem_bytes(bn, stages) > limit) --stages;
  return stages >= 2 ? stages : 0;
}

// ---- wgmma m64nNk16, bf16 x bf16 -> f32, both operands in shared memory,
// accumulating into d where acc != 0 and overwriting it where acc == 0 ----

template <int N>
struct Wg;

template <>
struct Wg<128> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wg<256> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(acc));
  }
};

// ---- the epilogue's stores ------------------------------------------------

// four 8 x 8 bf16 matrices from the warp's registers into shared memory:
// lane l gives the address of row l % 8 of matrix l / 8, and r[i] holds
// this thread's pair (row lane / 4, columns 2 (lane % 4), + 1) of matrix i
__device__ __forceinline__ void stmatrix_x4(void* p, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(hopper::smem_u32(p)), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// one 2-D box of shared memory into a tensor map's tensor (TMA; elements
// past the tensor's edge are not written), in this thread's bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(hopper::smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until this thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// waits until this thread's bulk groups are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- pass 1: the weight as bf16 --------------------------------------------

// 8 f32 values rounded to bf16 (round to nearest even), as 16 bytes
__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return u;
}

// W [N, K] bf16 from the codes: thread i takes 16 code columns of one row
// (Q8_0: columns c .. c+15; Q4_0: packed columns c .. c+15, whose low
// nibbles are columns c .. and high nibbles K/2 + c ..), each 16 columns
// within one 32-column block of one scale
template <bool kQ4>
__global__ void __launch_bounds__(256)
    dequant_bf16(const uint8_t* __restrict__ w,
                 const float* __restrict__ scales,
                 __nv_bfloat16* __restrict__ out, int N, int K) {
  const int kc = kQ4 ? K / 2 : K;  // code columns
  const int per_row = kc / 16;
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= (long)N * per_row) return;
  const int n = static_cast<int>(i / per_row);
  const int c = static_cast<int>(i % per_row) * 16;
  const uint4 raw =
      __ldg(reinterpret_cast<const uint4*>(w + (long)n * kc + c));
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  const float* srow = scales + (long)n * (K / 32);
  uint4* orow = reinterpret_cast<uint4*>(out + (long)n * K);
  // byte b of code word q, as a column of 16 (code column c + 4 q + b)
  auto code = [&](int q, int b) { return (words[q] >> (8 * b)) & 0xFFu; };
  if constexpr (kQ4) {
    const int hi0 = K / 2 + c;  // the high nibbles' first column
    const float s_lo = __ldg(srow + c / 32), s_hi = __ldg(srow + hi0 / 32);
    float lo[16], hi[16];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int u = static_cast<int>(code(q, b));
        lo[4 * q + b] = static_cast<float>((u & 0xF) - 8) * s_lo;
        hi[4 * q + b] = static_cast<float>((u >> 4) - 8) * s_hi;
      }
    orow[c / 8] = pack8(lo);
    orow[c / 8 + 1] = pack8(lo + 8);
    orow[hi0 / 8] = pack8(hi);
    orow[hi0 / 8 + 1] = pack8(hi + 8);
  } else {
    const float s = __ldg(srow + c / 32);
    float v[16];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v[4 * q + b] =
            static_cast<float>(static_cast<int8_t>(code(q, b))) * s;
    orow[c / 8] = pack8(v);
    orow[c / 8 + 1] = pack8(v + 8);
  }
}

}  // namespace large

// ---- pass 2: y = x . W^T ----------------------------------------------------
// grid: the plan's persistent blocks (at most one per SM), 384 threads.
// Block b takes tiles b, b + gridDim.x, ... of the ceil(M / 128) x
// ceil(N / BN) output tiles, tile t at x rows (t / tiles_n) * 128 and
// weight rows (t % tiles_n) * BN: the blocks in flight share a few x row
// tiles and the whole weight in L2.

template <int BN>
__global__ void __launch_bounds__(large::kThreads, 1)
    gemm_large(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap ty, int M, int N, int K,
               int stages) {
  using namespace large;
  using namespace sm90;
  constexpr int kA = kBM * 128;          // bytes of the x tile
  constexpr int kStage = kA + BN * 128;  // + the weight tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // the epilogue's staging: warpgroup wg's 64 x BN bf16 as BN / 64 boxes of
  // [64 rows][128 bytes], 128-byte swizzle (the y map's boxes)
  uint8_t* staging = base + stages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kBM * BN * 2);
  uint64_t* empty = full + stages;

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + kBM - 1) / kBM) * tiles_n;
  const int steps = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);   // the TMA issuer, with the stage's bytes
      bar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {
    // the producer warpgroup: one thread walks the block's tiles and steps
    // through the ring, ahead of the consumers by as many stages as the
    // ring holds, across tile boundaries
    if (tid == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tw))
                   : "memory");
      int g = 0;  // steps issued by this block
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * BN;
        for (int kb = 0; kb < steps; ++kb, ++g) {
          const int s = g % stages;
          if (g >= stages) bar_wait(&empty[s], ((g / stages) - 1) & 1);
          uint8_t* st = base + s * kStage;
          bar_expect(&full[s], kStage);
          tma_2d(st, &tx, kb * kBK, m0, &full[s]);
          tma_2d(st + kA, &tw, kb * kBK, n0, &full[s]);
        }
      }
    }
  } else {
    // the consumers: warpgroup wg owns the tile's x rows 64 wg .. 64 wg + 63
    const int wg = tid >> 7, lane = tid & 31, wq4 = (tid >> 5) & 3;
    // hands stage s back to the producer
    auto release = [&](int s) {
      if (lane == 0) bar_arrive(&empty[s]);
    };
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int g = 0;  // steps consumed by this block
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * BN;
      for (int kb = 0; kb < steps; ++kb, ++g) {
        const int s = g % stages;
        bar_wait(&full[s], (g / stages) & 1);
        const uint8_t* st = base + s * kStage;
        if constexpr (!(large::kProbe & 2)) {
          fence_acc<BN / 2>(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wg<BN>::run(acc, desc_sw128(st + wg * (64 * 128) + kk * 32),
                        desc_sw128(st + kA + kk * 32), kb | kk);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          fence_acc<BN / 2>(acc);
          // the previous step's wgmma has retired: its stage goes back
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          fence_acc<BN / 2>(acc);
        }
        if (kb > 0) release((g - 1) % stages);
      }
      if constexpr (!(large::kProbe & 2)) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc<BN / 2>(acc);
      }
      release((g - 1) % stages);

      // epilogue: the tile through shared memory into y by TMA, so the
      // stores are whole lines and leave the consumers at once; ragged M
      // and N are clipped by the map.
      // Warpgroup wg stages its 64 rows: the thread that issues its
      // stores first waits until the previous tile's have read the
      // staging.
      uint8_t* stg = staging + wg * (64 * BN * 2);
      const bool issuer = (tid & 127) == 0;
      if (issuer) bulk_wait_read();
      named_sync(1 + wg, 128);
      if (!(large::kProbe & 1)) {
        // stmatrix.x4 per pair of 8-column groups j, j + 1: matrices (rows
        // 0-7, j), (8-15, j), (0-7, j + 1), (8-15, j + 1) of this warp's
        // 16 rows; lane l addresses row l % 8 of matrix l / 8
        const int mi = lane >> 3;
        const int rr = 16 * wq4 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          const int col = 8 * (j + (mi >> 1));
          uint8_t* p = stg + (col / 64) * (64 * 128) + rr * 128 +
                       ((((col % 64) / 8) ^ (rr & 7)) << 4);
          stmatrix_x4(p, pack_bf16(acc[4 * j], acc[4 * j + 1]),
                      pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
                      pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
                      pack_bf16(acc[4 * j + 6], acc[4 * j + 7]));
        }
      }
      // the staging, written through the generic proxy, is read by TMA
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (issuer && !(large::kProbe & 1)) {
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_store_2d(&ty, stg + b * (64 * 128), n0 + 64 * b, m0 + 64 * wg);
        bulk_commit();
      }
    }
    if ((tid & 127) == 0) bulk_wait();  // the last stores are complete
  }
}

namespace large {

template <int BN>
int run(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& ty,
        int M, int N, int K, int blocks, cudaStream_t stream) {
  auto kernel = gemm_large<BN>;
  const int stages = ring_stages(BN);
  if (stages == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = smem_bytes(BN, stages);
  static dyn_smem::Limit limit;  // per device (smem_limit.cuh)
  if (const cudaError_t e = dyn_smem::allow(kernel, smem, limit, 0))
    return static_cast<int>(e);
  kernel<<<blocks, kThreads, smem, stream>>>(tx, tw, ty, M, N, K, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace large

// B4 / B5 with bf16 x, the large-M form: x [M, K] bf16, w the codes (Q8_0
// [N, K] int8, Q4_0 [N, K/2] half-split nibbles), scales [N, K/32] f32, y
// [M, N] bf16, wbuf [N, K] bf16 scratch for the dequantized weight; the
// plan's weight-row tile bn (128 or 256) and persistent blocks
template <bool kQ4>
int launch_large(const void* x, const void* w, const void* scales, void* y,
                 void* wbuf, int M, int N, int K, int bn, int blocks,
                 void* stream) {
  using namespace large;
  if (M <= 0 || N <= 0) return 0;
  if (K % (kQ4 ? 64 : 32) || N % 8 || wbuf == nullptr || blocks < 1 ||
      (bn != 128 && bn != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sm90::encoder() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  auto* st = static_cast<cudaStream_t>(stream);
  auto* wb = static_cast<__nv_bfloat16*>(wbuf);
  const long threads = (long)N * ((kQ4 ? K / 2 : K) / 16);
  dequant_bf16<kQ4><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const uint8_t*>(w), static_cast<const float*>(scales), wb,
      N, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tx, tw, ty;
  if (!sm90::map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, kBK,
                    kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wb, K, N, kBK,
                    bn, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::map_2d(&ty, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, N, M, 64,
                    64, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  return bn == 256 ? large::run<256>(tx, tw, ty, M, N, K, blocks, st)
                   : large::run<128>(tx, tw, ty, M, N, K, blocks, st);
}

}  // namespace wq
