// Weight-only quantized GEMM for Hopper, sm_90a: the body shared by kernels
// B4 (q8_matmul.cu, Q8_0) and B5 (q4_matmul.cu, Q4_0).
//
//     y[m, n] = sum_k x[m, k] * code(n, k) * scales[n, k / 32]
//
// x [M, K] row-major (f32 or bf16), y [M, N] in x's type, scales [N, K/32]
// f32. `Codes` reads the stored weight: Codes::load8(w, n, K, k0, c) fills
// c[0..7] with the integer codes of row n at k = k0 .. k0 + 7 (k0 % 8 ==
// 0), from one 8-byte load.
//
// What bounds it on the H100: at the serving shapes (M = B <= 256 streams,
// N, K in 1024..4096) one call reads the weight once, N*K bytes of codes
// (half that for Q4) plus N*K/8 bytes of scales, and does 2*M*N*K flops;
// M = 256 sits right at the bf16 tensor cores' ridge, so small batches are
// bound by the weight bytes and larger ones by the MMA rate. Design, a
// first version that is simple and right (no TMA, no wgmma, no
// multi-stage pipeline):
//   * one block per output tile, a K loop over steps of whole Q8_0 / Q4_0
//     blocks (32 inputs each, one scale per (row n, block));
//   * the step's x tile and weight tile go to shared memory; the weight is
//     dequantized there, code * scale in f32, into the operand type;
//   * f32 activations: FFMA with f32 sums, no TF32; 64x64 tiles, K steps
//     of 32, 256 threads with 4x4 outputs each;
//   * bf16 activations: the weight rounded to bf16 as the plain version
//     rounds it, mma.sync m16n8k16 on the tensor cores with f32
//     accumulators; 64x32 tiles (twice the blocks of a 64x64 tile for
//     N = 1024, so 128 blocks fill the 132 SMs at M = 256) and K steps of
//     128, four quantization blocks: each thread has 8 x loads and 4
//     weight loads in flight per step, where a step of 32 exposed the
//     load latency on every one of K/32 steps (measured: 0.17 ms for
//     M=256, N=1024, K=4096 at 32);
//   * ragged M and N are masked in the loads and the stores: the wrapper
//     never pads, and rows past M or N read as zero.
// The wrapper checks K % 32 == 0 (Q8) or K % 64 == 0 (Q4), 16-byte aligned
// x, contiguous weights.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wq {

constexpr int QB = 32;  // inputs per quantization block (one scale)

// ---- f32 activations: FFMA, 256 threads, 4x4 outputs per thread ----------

constexpr int BM = 64, BN = 64, BK = QB;  // f32 tile and K step

template <class Codes>
__global__ void __launch_bounds__(256)
gemm_f32(const float* __restrict__ x, const uint8_t* __restrict__ w,
         const float* __restrict__ scales, float* __restrict__ y, int M,
         int N, int K) {
  // K-major tiles, padded to keep float4 rows aligned
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = tid % 16, ty = tid / 16;
  const int kblocks = K / BK;
  float acc[4][4] = {};

  for (int kb = 0; kb < kblocks; ++kb) {
    // x tile: BM rows x BK = 512 float4 loads, 2 per thread
    for (int i = tid; i < BM * BK / 4; i += 256) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M)
        v = *reinterpret_cast<const float4*>(x + (long)(m0 + r) * K +
                                             kb * BK + c);
      xs[c + 0][r] = v.x;
      xs[c + 1][r] = v.y;
      xs[c + 2][r] = v.z;
      xs[c + 3][r] = v.w;
    }
    // weight tile: BN rows x 32 codes, 8 codes per thread
    {
      const int r = tid / 4, j0 = (tid % 4) * 8, n = n0 + r;
      float c[8] = {};
      if (n < N) {
        Codes::load8(w, n, K, kb * BK + j0, c);
        const float s = scales[(long)n * kblocks + kb];
#pragma unroll
        for (int j = 0; j < 8; ++j) c[j] *= s;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) ws[j0 + j][r] = c[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[(long)m * N + n] = acc[i][j];
    }
  }
}

// ---- bf16 activations: mma.sync m16n8k16, 128 threads, 32x16 per warp -----

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int HM = 64, HN = 32, HK = 4 * QB;  // bf16 tile and K step

template <class Codes>
__global__ void __launch_bounds__(128)
gemm_bf16(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scales, __nv_bfloat16* __restrict__ y,
          int M, int N, int K) {
  // row-major tiles, K contiguous, rows padded by 8 bf16 (16 bytes) so
  // the fragment loads of a warp hit 32 distinct banks
  constexpr int LD = HK + 8;
  __shared__ __align__(16) __nv_bfloat16 xs[HM][LD];
  __shared__ __align__(16) __nv_bfloat16 ws[HN][LD];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int m0 = blockIdx.y * HM, n0 = blockIdx.x * HN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 16;  // 32x16 per warp
  float acc[2][2][4] = {};

  for (int k0 = 0; k0 < K; k0 += HK) {
    const int kw = min(HK, K - k0);  // a multiple of 32
    // x tile: HM rows x kw/8 chunks of 8 bf16 (16 bytes)
    for (int i = tid; i < HM * HK / 8; i += 128) {
      const int r = i / (HK / 8), c = (i % (HK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && c < kw)
        v = *reinterpret_cast<const uint4*>(x + (long)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(&xs[r][c]) = v;
    }
    // weight tile: HN rows x kw/8 groups of 8 codes, dequantized as the
    // plain version does: bf16(f32(code) * scale)
    for (int i = tid; i < HN * HK / 8; i += 128) {
      const int r = i / (HK / 8), c = (i % (HK / 8)) * 8, n = n0 + r;
      float v[8] = {};
      float s = 0.f;
      if (n < N && c < kw) {
        Codes::load8(w, n, K, k0 + c, v);
        s = scales[(long)n * (K / QB) + (k0 + c) / QB];
      }
      union {
        uint4 u;
        __nv_bfloat16 h[8];
      } pack;
#pragma unroll
      for (int j = 0; j < 8; ++j) pack.h[j] = __float2bfloat16(v[j] * s);
      *reinterpret_cast<uint4*>(&ws[r][c]) = pack.u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HK; kk += 16) {
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + t4 * 2]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + t4 * 2]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + t4 * 2 + 8]);
        a[mi][3] =
            *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + t4 * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int n = wn + ni * 8 + g;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&ws[n][kk + t4 * 2]);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(&ws[n][kk + t4 * 2 + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }
  // accumulator fragment: c0, c1 at (g, 2*t4 + {0, 1}); c2, c3 at row g + 8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn + ni * 8 + t4 * 2 + (e & 1);
        if (m < M && n < N)
          y[(long)m * N + n] = __float2bfloat16(acc[mi][ni][e]);
      }
}

template <class Codes>
int launch_f32(const void* x, const void* w, const void* scales, void* y,
               int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32<Codes><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scales), static_cast<float*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <class Codes>
int launch_bf16(const void* x, const void* w, const void* scales, void* y,
                int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + HN - 1) / HN, (M + HM - 1) / HM);
  gemm_bf16<Codes><<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(y), M,
      N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wq
