// The Hopper GEMM body of kernels B4 (q8_matmul.cu, Q8_0) and B5
// (q4_matmul.cu, Q4_0) with bf16 activations, sm_90a, and (gemm_dense_sm90
// at the end) of B3's bf16 projections (t1_attention_block.cu):
//
//     y[m, n] = bf16( sum_k x[m, k] * bf16(code(n, k) * scale[n, k / 32]) )
//
// Replaces the TPU kernels nemotron_tpu/ops/quant.py, _q8_matmul_kernel /
// _q8_matmul_pallas (pallas_call at :126) and _q4_matmul_kernel /
// _q4_matmul_pallas (pallas_call at :280). The rounding points are the plain
// versions' (ops/quant.py): each weight rounded once to bf16 from its f32
// product, f32 sums, one bf16 rounding of the sum.
//
// What bounds it on the H100. At the main path's shapes (M = streams, 8 to
// 256; (N, K) = (4096, 1024), (1024, 4096), (2048, 1024), (1024, 1024)) one
// call moves the codes once (N*K bytes for Q8_0, half that for Q4_0, plus
// N*K/8 bytes of f32 scales), x (2*M*K bytes) and y (2*M*N), and does 2*M*N*K
// flops. At M = 256 the flops bind (2.2 us at 989 TFLOP/s for (4096, 1024),
// against 1.4 us of bytes at 3.35 TB/s); below M ~ 100 the bytes bind.
// From ops/quant.py:gemm_plan's crossover (M >= 1,024: the right-context
// ticks' and the offline path's rows) B4/B5 run wq_gemm_large.cuh instead:
// there this body's re-reads and re-dequantizations per 128 rows bound it
// (PERF.md).
//
// Design (what the earlier body, wq_matmul.cuh's gemm_bf16, lacked):
//   * Swapped operands. The block computes y^T = W . x^T on wgmma: 64 weight
//     rows fill wgmma's M, and the streams (M of the call) are wgmma's N, in
//     tiles of at most 128 rows padded to one of the widths of Mma<> below.
//     A ragged or small batch (8, 32, 141) costs no wasted 64-row tile.
//   * A shared-memory ring of as many stages as the device grants a block
//     (2 to kMaxStages, picked by the launcher), filled by one
//     producer warp: TMA for the x tile [m_tile, 64] bf16 (128-byte
//     swizzle) and the code tile [128, 64] bytes (tensor maps built in the
//     launcher; cudaGetDriverEntryPoint reaches cuTensorMapEncodeTiled
//     without linking libcuda), cp.async for the f32 scales (a scale row is
//     not 16-byte aligned for TMA unless K % 128 == 0), one mbarrier pair
//     per stage. For Q4_0 the 64 packed columns j.. j+63 hold the original
//     columns j.. and K/2 + j..: the stage loads both matching x tiles, and
//     each packed byte is read once.
//   * Two consumer warpgroups, 64 weight rows each. Each thread dequantizes
//     32 codes of one row per step into a 128-byte swizzled bf16 A tile in
//     shared memory (codes to f32 by placing the byte under the exponent of
//     2^23, exact and without the quarter-rate I2F), and the warpgroup runs
//     wgmma with both operands in shared memory (SS). SS and not A in
//     registers (RS): RS's fragment puts columns 2t, 2t+1, 2t+8, 2t+9 in one
//     thread, so each thread would gather its codes with 16-bit loads; SS
//     lets a thread read 32 consecutive codes with two 16-byte loads and
//     write four 16-byte chunks, and its cost (8 KB of shared stores per
//     warpgroup and step) is small beside wgmma's reads of the x tile.
//   * Enough blocks for the SMs. A block's step takes several times what
//     its bytes need (PERF.md), so the plan (ops/quant.py:gemm_plan, from
//     M, N, K and the device's SM count) gives ~one block per SM: it cuts
//     the batch into tiles of 64-128 rows (a second read of a code tile
//     comes from L2), and splits K where the N and M tiles still leave SMs
//     idle. The
//     splits write f32 partials to a workspace the wrapper allocates, and
//     gemm_splitk_reduce adds them in split order and rounds once. No
//     atomics: results repeat bit for bit.
//   * The epilogue stages the transposed accumulator through shared memory
//     (rows padded to 132 floats: no bank conflicts) and stores y[m, n]
//     coalesced, masking ragged M and N. Rows and columns past the tensor's
//     edge read as zero through TMA; scales past K are taken as 0.
// What holds it back (measured with tools/gemm_turns.py --probe, PERF.md):
// a fixed cost per call (launch, ring fill, epilogue, and the reduce's own
// launch where K is split) that alone exceeds the bound; the bare ring's
// round trip per step, which a deeper ring does not shorten; and, within a
// warpgroup, each step's dequantization and wgmma one after the other (one
// A tile, wait group 0). A second A tile with wait group 1 measured slower.
// The f32 partials of split-K can outweigh the codes.
// Shapes: K % 32 == 0 (K % 64 for Q4_0), x and the codes 16-byte aligned
// (the wrappers check).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"
#include "smem_limit.cuh"

namespace wq {
namespace sm90 {

constexpr int kRows = 128;     // weight rows per block: 2 warpgroups x 64
constexpr int kStep = 64;      // code columns per pipeline step
constexpr int kThreads = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int kLd = kRows + 4; // floats per staged row of the epilogue
// the ring holds as many stages as the device's shared memory per block
// allows, up to this many
#ifndef WQ_SM90_MAX_STAGES
#define WQ_SM90_MAX_STAGES 4
#endif
constexpr int kMaxStages = WQ_SM90_MAX_STAGES;
// measurement only (tools/gemm_turns.py --probe builds these variants):
// bit 1 leaves out the dequantization, bit 2 the wgmma; 0 in every build
// of the kernels
#ifndef WQ_SM90_PROBE
#define WQ_SM90_PROBE 0
#endif
constexpr int kProbe = WQ_SM90_PROBE;
constexpr int kATile = 64 * 128;  // bytes of one warpgroup's A tile

// shared memory of the ring (or of the epilogue's staging, the larger),
// rounded to 1 KB: the swizzled tiles need 1024-byte alignment
__host__ __device__ inline int stage_bytes(bool q4, int nt) {
  // x tile(s), codes, scales ([128 rows][2 or 4] f32)
  return (q4 ? 2 : 1) * nt * 128 + kRows * kStep + kRows * (q4 ? 4 : 2) * 4;
}

__host__ __device__ inline int region_bytes(bool q4, int nt, int stages) {
  const int stage = stage_bytes(q4, nt);
  const int ring = stages * stage, staging = nt * kLd * 4;
  return ((ring > staging ? ring : staging) + 1023) / 1024 * 1024;
}

inline int smem_bytes(bool q4, int nt, int stages) {
  // alignment slack + ring + A tiles + the stages' two mbarriers
  return 1024 + region_bytes(q4, nt, stages) + 2 * (q4 ? 2 : 1) * kATile +
         2 * stages * 8;
}

// the most stages (2 to kMaxStages) whose shared memory the current device
// grants one block; 0 where two do not fit
inline int ring_stages(bool q4, int nt) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  int stages = kMaxStages;
  while (stages >= 2 && smem_bytes(q4, nt, stages) > limit) --stages;
  return stages >= 2 ? stages : 0;
}

// ---- wgmma m64nNk16, bf16 x bf16 -> f32, both operands in shared memory --
// d: the N/2 accumulators of this thread; a, b: matrix descriptors.

template <int NT>
struct Mma;

template <>
struct Mma<16> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<48> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<80> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<96> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<112> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b) {
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
        : "l"(a), "l"(b), "r"(1));
  }
};

// ---- shared memory, mbarriers, TMA: hopper_async.cuh ------------------------

using namespace hopper;

// descriptor of a K-major tile of 128-byte rows, 128-byte swizzle: 8-row
// groups 1024 bytes apart (SBO); the k16 slices advance the start address
// by 32 bytes
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (static_cast<uint64_t>(smem_u32(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// keeps the compiler from moving any definition of the accumulator
// registers into a wgmma pipeline (which would serialize the wgmmas)
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 8 f32 values, rounded to bf16, into 16-byte chunk ch of row r of a
// 64-column A tile, in the 128-byte swizzle that TMA and wgmma use
__device__ __forceinline__ void put8(uint8_t* tile, int r, int ch,
                                     const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&p);
  }
  *reinterpret_cast<uint4*>(tile + r * 128 + ((ch ^ (r & 7)) << 4)) = u;
}

// the ring's barriers, by one thread: full[s] completes on `producers`
// arrivals (and the TMA bytes expected), empty[s] on the 256 consumers'
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int stages, int producers) {
  for (int s = 0; s < stages; ++s) {
    bar_init(&full[s], producers);
    bar_init(&empty[s], 256);
  }
}

}  // namespace sm90

// ---- the kernel ---------------------------------------------------------------
// grid (ceil(N / 128), ceil(M / NT), splits), 288 threads. Split z walks
// steps [z * steps_per, min(steps, (z + 1) * steps_per)) of 64 code columns;
// with one split it stores y, with more its f32 partial into ws[z].

template <bool kQ4, int NT>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    gemm_sm90(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw,
              const float* __restrict__ scales, __nv_bfloat16* __restrict__ y,
              float* __restrict__ ws, int M, int N, int K, int steps,
              int steps_per, int stages) {
  using namespace sm90;
  constexpr int kX = NT * 128;            // bytes of one x tile
  constexpr int kXTiles = kQ4 ? 2 : 1;
  constexpr int kScales = kQ4 ? 4 : 2;  // scales per row and step
  constexpr int kStage = kXTiles * kX + kRows * kStep + kRows * kScales * 4;
  constexpr int kTx = kXTiles * kX + kRows * kStep;  // bytes through TMA
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* a_tiles = base + region_bytes(kQ4, NT, stages);
  // A tiles: [warpgroup][low, high nibbles]
  uint64_t* full = reinterpret_cast<uint64_t*>(a_tiles + 2 * kXTiles * kATile);
  uint64_t* empty = full + stages;

  const int n0 = blockIdx.x * kRows, m0 = blockIdx.y * NT, z = blockIdx.z;
  const int it0 = z * steps_per, it1 = min(steps, it0 + steps_per);
  const int tid = threadIdx.x;
  if (tid == 0) {
    ring_init(full, empty, stages, 1 + 32);  // the TMA issuer + the scales
    bar_init_fence();
  }
  __syncthreads();

  const int kc = kQ4 ? K / 2 : K;  // code columns
  if (tid >= 256) {
    // the producer warp: lane 0 issues the tiles' TMA copies; every lane
    // copies the scales of 4 rows (cp.async: a row of [N, K/32] f32 is not
    // 16-byte aligned for TMA when K % 128 != 0), [0, 1] for the step's two
    // 32-column blocks and, for Q4_0, [2, 3] for the high nibbles' blocks
    const int lane = tid - 256;
    // a step's two scales of a row are one 8-byte copy where aligned
    const bool pairs8 = (K / 32) % 2 == 0 && (!kQ4 || (K / 64) % 2 == 0) &&
                        (reinterpret_cast<uintptr_t>(scales) & 7) == 0;
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tw))
                   : "memory");
    }
    for (int it = it0; it < it1; ++it) {
      const int i = it - it0, s = i % stages;
      if (i >= stages) bar_wait(&empty[s], ((i / stages) - 1) & 1);
      uint8_t* st = base + s * kStage;
      const int col = it * kStep;
      if (lane == 0) {
        bar_expect(&full[s], kTx);
        tma_2d(st, &tx, col, m0, &full[s]);
        if constexpr (kQ4) tma_2d(st + kX, &tx, K / 2 + col, m0, &full[s]);
        tma_2d(st + kXTiles * kX, &tw, col, n0, &full[s]);
      }
      float* ss = reinterpret_cast<float*>(st + kTx);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int row = lane + 32 * rr, n = n0 + row;
        const bool ok0 = n < N && col < kc, ok1 = n < N && col + 32 < kc;
#pragma unroll
        for (int pair = 0; pair < kScales / 2; ++pair) {  // Q4_0: low, high
          float* dst = ss + row * kScales + 2 * pair;
          const float* src =
              scales + (long)n * (K / 32) + (col + (pair ? K / 2 : 0)) / 32;
          if (ok1 && pairs8) {
            cp_async8(dst, src);
          } else {
            cp_async4(dst, ok0 ? src : scales, ok0);
            cp_async4(dst + 1, ok1 ? src + 1 : scales, ok1);
          }
        }
      }
      cp_async_arrive(&full[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns weight rows n0 + 64 wg .. + 63; thread t
  // dequantizes 32 codes of row r (the rows its own warp's slice of wgmma
  // reads), half h of the step's 64 code columns
  const int wg = tid >> 7, t = tid & 127;
  const int r = t >> 1, h = t & 1;
  uint8_t* a_wg = a_tiles + wg * kXTiles * kATile;

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  fence_acc<NT / 2>(acc);

  for (int it = it0; it < it1; ++it) {
    const int i = it - it0, s = i % stages;
    uint8_t* a_lo = a_wg;
    uint8_t* a_hi = a_wg + kATile;  // Q4_0: the high nibbles' tile
    bar_wait(&full[s], (i / stages) & 1);
    const uint8_t* st = base + s * kStage;
    if constexpr (!(kProbe & 1)) {
      // this thread's scales: [0] for its codes (Q4_0: the low nibbles), [1]
      // for Q4_0's high nibbles; 0 past the row's end
      const float* ss =
          reinterpret_cast<const float*>(st + kTx) + (wg * 64 + r) * kScales;
      const float sc[2] = {ss[h], kQ4 ? ss[2 + h] : 0.f};
      const uint8_t* cp = st + kXTiles * kX + (wg * 64 + r) * kStep + h * 32;
      const uint4 c0 = *reinterpret_cast<const uint4*>(cp);
      const uint4 c1 = *reinterpret_cast<const uint4*>(cp + 16);
      const uint32_t words[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      // codes to f32 exactly without I2F (a quarter-rate unit): byte u of a
      // word placed under the exponent of 2^23 reads as 2^23 + u; Q8_0 codes
      // are offset by 128 first (x ^ 0x80), Q4_0 nibbles (0..15) code u - 8
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // 8 codes per 16-byte chunk
        float v[8];
        if constexpr (kQ4) {
          float u[8];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t w = words[2 * q + half];
            const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float a = __int_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 | j));
              const float b = __int_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 | j));
              v[4 * half + j] = (a - 8388616.0f) * sc[0];  // 2^23 + 8
              u[4 * half + j] = (b - 8388616.0f) * sc[1];
            }
          }
          put8(a_hi, r, h * 4 + q, u);
        } else {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t w = words[2 * q + half] ^ 0x80808080u;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float a = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | j));
              v[4 * half + j] = (a - 8388736.0f) * sc[0];  // 2^23 + 128
            }
          }
        }
        put8(a_lo, r, h * 4 + q, v);
      }
    }
    // the A tile, written through the generic proxy, is read by wgmma
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if constexpr (!(kProbe & 2)) {
      fence_acc<NT / 2>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Mma<NT>::run(acc, desc_sw128(a_lo + kk * 32), desc_sw128(st + kk * 32));
      if constexpr (kQ4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<NT>::run(acc, desc_sw128(a_hi + kk * 32),
                       desc_sw128(st + kX + kk * 32));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc<NT / 2>(acc);
      // this step's wgmma is done: its stage goes back to the producer, and
      // the A tile may be written again. So within a warpgroup the next
      // step's dequantization waits for this step's wgmma (one A tile, wait
      // group 0); only the other warpgroup overlaps them.
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc<NT / 2>(acc);
    }
    bar_arrive(&empty[s]);  // the stage goes back to the producer
  }

  // epilogue: the accumulator fragment (rows 16w + g and + 8 of the
  // warpgroup's 64, columns 8j + 2q and + 1) staged as [m][n] f32, then
  // stored coalesced along n. gemm_dense_sm90 below stages the same way;
  // written out in each kernel, not as one inlined function: that function
  // (three forms of it) cost B5 1.4-1.9% at batch tiles of 80 rows (PERF.md)
  named_sync(3, 256);  // both warpgroups are done with the ring
  float* stg = reinterpret_cast<float*>(base);
  {
    const int w = t >> 5, g = (t & 31) >> 2, q = t & 3;
    const int nl = wg * 64 + 16 * w + g;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int m = 8 * j + 2 * q;
      stg[m * kLd + nl] = acc[4 * j];
      stg[(m + 1) * kLd + nl] = acc[4 * j + 1];
      stg[m * kLd + nl + 8] = acc[4 * j + 2];
      stg[(m + 1) * kLd + nl + 8] = acc[4 * j + 3];
    }
  }
  named_sync(3, 256);
  for (int idx = tid; idx < NT * kRows; idx += 256) {
    const int m = idx / kRows, nl = idx % kRows;
    const int gm = m0 + m, gn = n0 + nl;
    if (gm < M && gn < N) {
      const float v = stg[m * kLd + nl];
      if (gridDim.z == 1)
        y[(long)gm * N + gn] = __float2bfloat16(v);
      else
        ws[((long)z * M + gm) * N + gn] = v;
    }
  }
}

// y = bf16 of the partials summed in split order; 4 outputs per thread
// (mn % 4 == 0) or 1, every split's load issued before the sums
static __global__ void gemm_splitk_reduce(const float* __restrict__ ws,
                                          __nv_bfloat16* __restrict__ y,
                                          long mn, int splits) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (mn % 4 == 0) {
    if (4 * i >= mn) return;
    const float4* w4 = reinterpret_cast<const float4*>(ws) + i;
    const long stride = mn / 4;
    float4 a = __ldg(w4);
    for (int z = 1; z < splits; z += 4) {
      float4 b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (z + u < splits) b[u] = __ldg(w4 + (z + u) * stride);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (z + u < splits) {
          a.x += b[u].x;
          a.y += b[u].y;
          a.z += b[u].z;
          a.w += b[u].w;
        }
    }
    __nv_bfloat162* y2 = reinterpret_cast<__nv_bfloat162*>(y) + 2 * i;
    y2[0] = __floats2bfloat162_rn(a.x, a.y);
    y2[1] = __floats2bfloat162_rn(a.z, a.w);
  } else if (i < mn) {
    float a = ws[i];
    for (int z = 1; z < splits; ++z) a += ws[z * mn + i];
    y[i] = __float2bfloat16(a);
  }
}

// ---- the launcher ---------------------------------------------------------------

namespace sm90 {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [rows, cols] tensor, boxes of [box_rows, box_cols]
inline bool map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
                   const void* ptr, long cols, long rows, int box_cols,
                   int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return encoder()(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                   one, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kQ4, int NT>
int run(const CUtensorMap& tx, const CUtensorMap& tw, const float* scales,
        __nv_bfloat16* y, float* ws, int M, int N, int K, int splits,
        int steps, int steps_per, cudaStream_t stream) {
  auto kernel = gemm_sm90<kQ4, NT>;
  const int stages = ring_stages(kQ4, NT);
  if (stages == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = smem_bytes(kQ4, NT, stages);
  static dyn_smem::Limit limit;  // per device (smem_limit.cuh)
  if (const cudaError_t e = dyn_smem::allow(kernel, smem, limit, 0))
    return static_cast<int>(e);
  const dim3 grid((N + kRows - 1) / kRows, (M + NT - 1) / NT, splits);
  kernel<<<grid, kThreads, smem, stream>>>(tx, tw, scales, y, ws, M, N, K,
                                           steps, steps_per, stages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long mn = (long)M * N;
  const long threads = mn % 4 == 0 ? mn / 4 : mn;
  gemm_splitk_reduce<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      ws, y, mn, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

// B4 / B5 with bf16 x: x [M, K] bf16, w the codes (Q8_0 [N, K] int8, Q4_0
// [N, K/2] half-split nibbles), scales [N, K/32] f32, y [M, N] bf16, ws
// [splits, M, N] f32 (unused with one split); the plan's m_tile (one of
// Mma<>'s widths), splits and steps per split
template <bool kQ4>
int launch_sm90(const void* x, const void* w, const void* scales, void* y,
                void* ws, int M, int N, int K, int m_tile, int splits,
                int steps_per, void* stream) {
  using namespace sm90;
  if (M <= 0 || N <= 0) return 0;
  const int kc = kQ4 ? K / 2 : K;
  const int steps = (kc + kStep - 1) / kStep;
  if (splits < 1 || steps_per < 1 ||
      (long)(splits - 1) * steps_per >= steps ||
      (long)splits * steps_per < steps || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tx, tw;
  if (!map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, 64, m_tile,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, kc, N, kStep, kRows,
              CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const float*>(scales);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* wsf = static_cast<float*>(ws);
  auto* st = static_cast<cudaStream_t>(stream);
#define WQ_CASE(nt)                                                        \
  case nt:                                                                 \
    return run<kQ4, nt>(tx, tw, s, yb, wsf, M, N, K, splits, steps,        \
                        steps_per, st);
  switch (m_tile) {
    WQ_CASE(16)
    WQ_CASE(32)
    WQ_CASE(48)
    WQ_CASE(64)
    WQ_CASE(80)
    WQ_CASE(96)
    WQ_CASE(112)
    WQ_CASE(128)
  }
#undef WQ_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- B3's bf16 projections: dense weights ------------------------------------
// y^T = W . b^T with W one of up to three [rows, K] bf16 matrices (B3's q,
// k and v weights: three tensor maps, so no tile straddles two of them; or
// its out weight), read through TMA with the 128-byte swizzle straight into
// wgmma's A slot: nothing is dequantized and the consumers write no A tile
// (the serialized transform-then-wgmma step of B4/B5 above is gone). The
// B operand, the streams:
//   kLn  (the QKV GEMM): the block's NT rows of x, all K columns, come in
//        through TMA once, as 64-column swizzled atoms, into a resident
//        operand; the consumers take each row's mean and 1/sqrt(var + eps)
//        from there (two passes, population variance) and normalise the
//        split's atoms in place, rounded to bf16 (the reference's rounding
//        point y = LN(x) in x's type): LN once per block, and only the
//        weights stream through the ring. Out: the f32 sums into ws[split][m][part * rows + n] (the
//        attention launch adds the splits in split order: no atomics, no
//        extra launch, results repeat bit for bit);
//   !kLn (the out GEMM): x tiles [NT, 64] through the ring beside the
//        weight tiles; out: y = bf16(res + sum), summed in f32, rounded once.
// grid (parts * tiles_per_part, ceil(M / NT), splits), 288 threads: lane 0
// of the producer warp issues the TMA copies, two consumer warpgroups of 64
// weight rows each run SS wgmma with f32 sums (fenced as in gemm_sm90);
// the ring's barriers are gemm_sm90's (ring_init) and the epilogue stages
// as its does. Rows past the weight's or the batch's edge read as zero
// through TMA and are masked in the stores.

struct DenseArgs {
  const __nv_bfloat16* x;     // [M, K]: LN's input (kLn) or the B operand
  const __nv_bfloat16* ln_w;  // [K] (kLn)
  const __nv_bfloat16* ln_b;  // [K] (kLn)
  float eps;
  float* ws;                  // kLn: [splits, M, parts * rows] f32
  __nv_bfloat16* y;           // !kLn: [M, rows]
  const __nv_bfloat16* res;   // !kLn: [M, rows]
  int M, rows, K, tiles_per_part, steps, steps_per;
};

namespace sm90 {

constexpr int kWTile = kRows * 128;  // bytes of a [128, 64] bf16 weight tile

// the ring (or the epilogue's staging, the larger), rounded to 1 KB
__host__ __device__ inline int dense_region(bool ln, int nt, int stages) {
  const int ring = stages * (kWTile + (ln ? 0 : nt * 128));
  const int staging = nt * kLd * 4;
  return ((ring > staging ? ring : staging) + 1023) / 1024 * 1024;
}

// alignment slack + region + (kLn: resident operand of all `steps` atoms
// + row statistics + its barrier) + the ring's barriers
// (ops/attn_block.py:dense_smem computes the same)
__host__ __device__ inline int dense_smem(bool ln, int nt, int steps,
                                          int stages) {
  return 1024 + dense_region(ln, nt, stages) +
         (ln ? nt * 128 * steps + nt * 8 + 8 : 0) + 16 * stages;
}

inline int dense_stages(bool ln, int nt, int steps) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  int stages = kMaxStages;
  while (stages >= 2 && dense_smem(ln, nt, steps, stages) > limit) --stages;
  return stages >= 2 ? stages : 0;
}

// 8 bf16 values from global memory as f32
__device__ __forceinline__ void ld8_bf16(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace sm90

template <bool kLn, int NT>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    gemm_dense_sm90(const __grid_constant__ CUtensorMap tw0,
                    const __grid_constant__ CUtensorMap tw1,
                    const __grid_constant__ CUtensorMap tw2,
                    const __grid_constant__ CUtensorMap tx, const DenseArgs a,
                    int stages) {
  using namespace sm90;
  constexpr int kStage = kWTile + (kLn ? 0 : NT * 128);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // kLn: the resident operand, [steps][NT rows][128 bytes] swizzled
  uint8_t* resident = base + dense_region(kLn, NT, stages);
  float2* stats = reinterpret_cast<float2*>(
      resident + (kLn ? NT * 128 * a.steps : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(stats) + (kLn ? NT * 8 : 0));
  uint64_t* empty = full + stages;
  uint64_t* xbar = empty + stages;  // kLn: the resident x rows

  const int part = blockIdx.x / a.tiles_per_part;
  const int n0 = (blockIdx.x % a.tiles_per_part) * kRows;  // row in the part
  const int m0 = blockIdx.y * NT, z = blockIdx.z;
  const int it0 = z * a.steps_per, it1 = min(a.steps, it0 + a.steps_per);
  const int tid = threadIdx.x;
  if (tid == 0) {
    ring_init(full, empty, stages, 1);
    if (kLn) bar_init(xbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer: weight tiles (and x tiles) into the ring
    if (tid == 256) {
      const CUtensorMap* tw = part == 0 ? &tw0 : part == 1 ? &tw1 : &tw2;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(tw))
                   : "memory");
      if constexpr (kLn) {  // the block's x rows, every column, once
        bar_expect(xbar, NT * 128 * a.steps);
        for (int c = 0; c < a.steps; ++c)
          tma_2d(resident + c * (NT * 128), &tx, c * kStep, m0, xbar);
      }
      for (int it = it0; it < it1; ++it) {
        const int i = it - it0, s = i % stages;
        if (i >= stages) bar_wait(&empty[s], ((i / stages) - 1) & 1);
        uint8_t* st = base + s * kStage;
        bar_expect(&full[s], kStage);
        tma_2d(st, tw, it * kStep, n0, &full[s]);
        if constexpr (!kLn) tma_2d(st + kWTile, &tx, it * kStep, m0, &full[s]);
      }
    }
    return;
  }

  const int wg = tid >> 7;
  if constexpr (kLn) {
    // chunk ch (8 values) of row r of the resident x rows
    auto chunk = [&](int r, int ch) {
      return reinterpret_cast<uint4*>(resident + (ch >> 3) * (NT * 128) +
                                      r * 128 + (((ch & 7) ^ (r & 7)) << 4));
    };
    auto get8 = [](uint4 u, float* v) {
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    };
    bar_wait(xbar, 0);
    // the statistics of the block's rows over the whole row: warp w of the
    // eight consumer warps takes rows w, w + 8, ... (rows past M are zero)
    const int lane = tid & 31, warp = tid >> 5, chunks = a.K / 8;
    for (int r = warp; r < NT; r += 8) {
      float sum = 0.f, sq = 0.f, v[8];
      for (int ch = lane; ch < chunks; ch += 32) {
        get8(*chunk(r, ch), v);
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += v[j];
      }
      const float mu = warp_sum(sum) / a.K;
      for (int ch = lane; ch < chunks; ch += 32) {
        get8(*chunk(r, ch), v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = v[j] - mu;
          sq = fmaf(d, d, sq);
        }
      }
      const float rstd = 1.f / sqrtf(warp_sum(sq) / a.K + a.eps);
      if (lane == 0) stats[r] = make_float2(mu, rstd);
    }
    named_sync(1, 256);
    // this split's atoms normalised in place, rounded to bf16; columns past
    // K stay zero
    const int c0 = it0 * 8, n_ch = min(a.K / 8, it1 * 8) - c0;
    for (int idx = tid; idx < NT * n_ch; idx += 256) {
      const int r = idx / n_ch, ch = c0 + idx % n_ch, k = 8 * ch;
      float v[8], w[8], b[8];
      get8(*chunk(r, ch), v);
      ld8_bf16(a.ln_w + k, w);
      ld8_bf16(a.ln_b + k, b);
      const float2 st = stats[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = (v[j] - st.x) * st.y * w[j] + b[j];
      put8(resident + (ch >> 3) * (NT * 128), r, ch & 7, v);
    }
    // the operand, written through the generic proxy, is read by wgmma
    fence_proxy_async();
    named_sync(1, 256);
  }

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  fence_acc<NT / 2>(acc);
  for (int it = it0; it < it1; ++it) {
    const int i = it - it0, s = i % stages;
    bar_wait(&full[s], (i / stages) & 1);
    const uint8_t* st = base + s * kStage;
    const uint8_t* bt = kLn ? resident + it * (NT * 128) : st + kWTile;
    fence_acc<NT / 2>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<NT>::run(acc, desc_sw128(st + wg * (kWTile / 2) + kk * 32),
                   desc_sw128(bt + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc<NT / 2>(acc);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc<NT / 2>(acc);
    bar_arrive(&empty[s]);  // the stage goes back to the producer
  }

  // epilogue, staged as gemm_sm90's (see there why it is written out)
  named_sync(3, 256);
  float* stg = reinterpret_cast<float*>(base);
  {
    const int t = tid & 127, w = t >> 5, g = (t & 31) >> 2, q = t & 3;
    const int nl = wg * 64 + 16 * w + g;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int m = 8 * j + 2 * q;
      stg[m * kLd + nl] = acc[4 * j];
      stg[(m + 1) * kLd + nl] = acc[4 * j + 1];
      stg[m * kLd + nl + 8] = acc[4 * j + 2];
      stg[(m + 1) * kLd + nl + 8] = acc[4 * j + 3];
    }
  }
  named_sync(3, 256);
  const int parts = gridDim.x / a.tiles_per_part;
  for (int idx = tid; idx < NT * kRows; idx += 256) {
    const int m = idx / kRows, nl = idx % kRows;
    const int gm = m0 + m, gn = n0 + nl;
    if (gm < a.M && gn < a.rows) {
      const float v = stg[m * kLd + nl];
      if constexpr (kLn) {
        a.ws[((long)z * a.M + gm) * parts * a.rows + part * a.rows + gn] = v;
      } else {
        const long o = (long)gm * a.rows + gn;
        a.y[o] = a.res ? __float2bfloat16(__bfloat162float(a.res[o]) + v)
                       : __float2bfloat16(v);
      }
    }
  }
}

namespace sm90 {

template <bool kLn, int NT>
int run_dense(const CUtensorMap* tw, const CUtensorMap& tx,
              const DenseArgs& a, dim3 grid, cudaStream_t stream) {
  auto kernel = gemm_dense_sm90<kLn, NT>;
  const int stages = dense_stages(kLn, NT, a.steps);
  if (stages == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = dense_smem(kLn, NT, a.steps, stages);
  static dyn_smem::Limit limit;  // per device (smem_limit.cuh)
  if (const cudaError_t e = dyn_smem::allow(kernel, smem, limit, 0))
    return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(tw[0], tw[1], tw[2], tx, a,
                                           stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

// B3's bf16 projections on the plan of ops/attn_block.py:block_gemm_plans.
// kLn (QKV): x [M, K] is LN's input, w[0 .. parts) the [rows, K] weights,
// f32 sums into ws [splits, M, parts * rows]. !kLn (out): x [M, K] is the
// B operand, w[0] the weight, y [M, rows] = bf16(res + x . w^T), one split
// (bf16(x . w^T) where res is null: a tp shard's partial).
template <bool kLn>
int launch_dense(const void* x, const void* ln_w, const void* ln_b,
                 float eps, const void* const* w, int parts, void* ws,
                 void* y, const void* res, int M, int rows, int K, int nt,
                 int splits, int steps_per, void* stream) {
  using namespace sm90;
  if (M <= 0 || rows <= 0) return 0;
  const int steps = (K + kStep - 1) / kStep;
  if (parts < 1 || parts > 3 || splits < 1 || steps_per < 1 ||
      (long)(splits - 1) * steps_per >= steps ||
      (long)splits * steps_per < steps || (!kLn && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tw[3], tx;
  for (int p = 0; p < parts; ++p)
    if (!map_2d(&tw[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w[p], K, rows,
                kStep, kRows, CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorInvalidValue);
  for (int p = parts; p < 3; ++p) tw[p] = tw[0];
  if (!map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, kStep, nt,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (rows + kRows - 1) / kRows;
  const DenseArgs a{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const __nv_bfloat16*>(ln_w),
                    static_cast<const __nv_bfloat16*>(ln_b),
                    eps,
                    static_cast<float*>(ws),
                    static_cast<__nv_bfloat16*>(y),
                    static_cast<const __nv_bfloat16*>(res),
                    M, rows, K, tiles, steps, steps_per};
  const dim3 grid(parts * tiles, (M + nt - 1) / nt, splits);
  auto* st = static_cast<cudaStream_t>(stream);
#define WQ_DENSE(n)                                  \
  case n:                                            \
    return run_dense<kLn, n>(tw, tx, a, grid, st);
  if constexpr (kLn) {  // the resident operand keeps batch tiles <= 64
    switch (nt) {
      WQ_DENSE(16)
      WQ_DENSE(32)
      WQ_DENSE(48)
      WQ_DENSE(64)
    }
  } else {
    switch (nt) {
      WQ_DENSE(16)
      WQ_DENSE(32)
      WQ_DENSE(48)
      WQ_DENSE(64)
      WQ_DENSE(80)
      WQ_DENSE(96)
      WQ_DENSE(112)
      WQ_DENSE(128)
    }
  }
#undef WQ_DENSE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wq
