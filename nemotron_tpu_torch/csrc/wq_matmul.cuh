// GEMM body for Hopper, sm_90a, with f32 activations: kernels B4
// (q8_matmul.cu, Q8_0) and B5 (q4_matmul.cu, Q4_0) in f32, and the
// projections of B3 (t1_attention_block.cu) in f32. Every bf16 form (B4,
// B5, B3's projections) runs on wq_gemm_sm90.cuh instead.
//
//     y[m, n] = epilogue(m, n, sum_k a(m, k) * w(n, k))
//
// Three policies make one kernel serve all of them:
//   * the A loader gives a(m, k): PlainA reads x [M, K] row-major; LnA
//     reads x and applies a layer norm whose row statistics (mean,
//     1/sqrt(var + eps), f32, population variance) the block computes
//     first for its own rows, so the normalised rows never reach memory;
//   * the weight loader gives 8 values of row n from k0 (k0 % 8 == 0) as
//     f32: QuantW dequantizes Q8_0 / Q4_0 codes (`Codes::load8(w, n, K, k0,
//     c)` reads the integer codes, times the per-32-input scale [N, K/32]);
//     DenseW reads up to three row-major [rows, K] matrices stacked along N;
//   * the epilogue stores y[m, n] from the f32 sum (in x's type, in f32,
//     or added to a residual).
//
// What bounds it on the H100: at the serving shapes (M = B <= 256 streams,
// N, K in 1024..4096) one call reads the weight once and does 2*M*N*K
// flops; f32 activations run on the CUDA cores (67 TFLOP/s, no TF32), so
// the flops bind from M ~ 16 up. Design, a first version that is simple
// and right (no TMA, no multi-stage pipeline; f32 is the parity form):
//   * one block per output tile, a K loop over steps of whole Q8_0 / Q4_0
//     blocks (32 inputs each, one scale per (row n, block));
//   * the step's x tile and weight tile go to shared memory, the weight
//     dequantized there (code * scale in f32);
//   * FFMA with f32 sums, no TF32; 64x64 tiles, K steps of 32, 256
//     threads with 4x4 outputs each;
//   * ragged M and N are masked in the loads and the stores: the wrapper
//     never pads, and rows past M or N read as zero.
// The wrappers check K % 32 == 0 (K % 64 == 0 for Q4), 16-byte aligned
// rows, contiguous weights.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>


namespace wq {

constexpr int QB = 32;  // inputs per quantization block (one scale)

// ---- loads of 4 or 8 consecutive values as f32 ---------------------------
// Every global read of the operands goes through __ldg, the read-only
// path: the policies below hold plain pointers, which the compiler cannot
// prove unaliased as it could the kernels' __restrict__ arguments.

template <int NV>
__device__ __forceinline__ void ld_f32(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < NV; i += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
    v[i] = a.x;
    v[i + 1] = a.y;
    v[i + 2] = a.z;
    v[i + 3] = a.w;
  }
}

__device__ __forceinline__ void store(float* y, float v) { *y = v; }

__device__ __forceinline__ float val(float x) { return x; }

// ---- A loaders: load<NV>(..., m, k, v) fills v[0..NV) = a(m, k .. k+NV) ---

template <typename T>
struct PlainA {
  const T* x;
  int K;
  static constexpr bool kStats = false;
  template <int NV>
  __device__ void load(int m, int k, float* v) const {
    ld_f32<NV>(x + (long)m * K + k, v);
  }
};

template <typename T>
struct LnA {
  const T* x;
  const T* ln_w;
  const T* ln_b;
  float eps;
  int K;
  static constexpr bool kStats = true;

  // mean and 1/sqrt(var + eps) of rows m0 .. m0 + rows - 1 into st[], each
  // row by one warp (two passes over the row, as the reference formula)
  __device__ void stats(float2* st, int m0, int rows, int M) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < rows; r += blockDim.x >> 5) {
      float mu = 0.f, var = 0.f;
      if (m0 + r < M) {
        const T* row = x + (long)(m0 + r) * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += val(row[k]);
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        mu = s / K;
        float q = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float d = val(row[k]) - mu;
          q = fmaf(d, d, q);
        }
        for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
        var = q / K;
      }
      if (lane == 0) st[r] = make_float2(mu, 1.f / sqrtf(var + eps));
    }
  }

  // st is indexed by the row within the block's tile
  template <int NV>
  __device__ void load(const float2* st, int r, int m, int k, float* v) const {
    ld_f32<NV>(x + (long)m * K + k, v);
    const float2 s = st[r];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      v[j] = (v[j] - s.x) * s.y * val(ln_w[k + j]) + val(ln_b[k + j]);
  }
};

// dispatch: PlainA ignores the tile row, LnA reads its statistics
template <int NV, typename A>
__device__ __forceinline__ void load_a(const A& a, const float2* st, int r,
                                       int m, int k, float* v) {
  if constexpr (A::kStats)
    a.template load<NV>(st, r, m, k, v);
  else
    a.template load<NV>(m, k, v);
}

// ---- weight loaders: load8(n, k0, c) fills c[0..8) = w(n, k0 .. k0+8) ----

template <class Codes>
struct QuantW {
  const uint8_t* w;
  const float* scales;  // [N, K / QB]
  int K;
  __device__ void load8(int n, int k0, float* c) const {
    Codes::load8(w, n, K, k0, c);
    const float s = __ldg(scales + (long)n * (K / QB) + k0 / QB);
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] *= s;
  }
};

template <typename T>
struct DenseW {
  const T* part[3];  // row n lies in part[n / rows] at row n % rows
  int rows;
  int K;
  __device__ void load8(int n, int k0, float* c) const {
    ld_f32<8>(part[n / rows] + (long)(n % rows) * K + k0, c);
  }
};

// ---- epilogues: e(m, n, acc) ---------------------------------------------

template <typename T>
struct StoreY {
  T* y;
  int N;
  __device__ void operator()(int m, int n, float acc) const {
    store(y + (long)m * N + n, acc);
  }
};

template <typename T>
struct AddResidual {  // y = res + acc, summed in f32, rounded once
  T* y;
  const T* res;
  int N;
  __device__ void operator()(int m, int n, float acc) const {
    const long i = (long)m * N + n;
    store(y + i, val(__ldg(res + i)) + acc);
  }
};

// ---- f32 activations: FFMA, 256 threads, 4x4 outputs per thread ----------

constexpr int BM = 64, BN = 64, BK = QB;  // f32 tile and K step

template <class A, class W, class E>
__global__ void __launch_bounds__(256)
gemm_f32(A a, W w, E e, int M, int N, int K) {
  // K-major tiles, padded to keep float4 rows aligned
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BN + 4];
  __shared__ float2 stats[BM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  if constexpr (A::kStats) {
    a.stats(stats, m0, BM, M);
    __syncthreads();
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: BM rows x BK = 512 groups of 4, 2 per thread
    for (int i = tid; i < BM * BK / 4; i += 256) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (m0 + r < M) load_a<4>(a, stats, r, m0 + r, k0 + c, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[c + j][r] = v[j];
    }
    // weight tile: BN rows x 32 values, 8 per thread
    {
      const int r = tid / 4, j0 = (tid % 4) * 8, n = n0 + r;
      float c[8] = {};
      if (n < N) w.load8(n, k0 + j0, c);
#pragma unroll
      for (int j = 0; j < 8; ++j) ws[j0 + j][r] = c[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av4 = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 bv4 = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w};
      const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
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
      if (n < N) e(m, n, acc[i][j]);
    }
  }
}

// ---- launchers -------------------------------------------------------------

template <class A, class W, class E>
int run_f32(const A& a, const W& w, const E& e, int M, int N, int K,
            void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, w, e, M,
                                                                 N, K);
  return static_cast<int>(cudaGetLastError());
}

// B4 / B5 with f32 x: y = x . dequant(w)^T in f32
template <class Codes>
int launch_f32(const void* x, const void* w, const void* scales, void* y,
               int M, int N, int K, void* stream) {
  return run_f32(PlainA<float>{static_cast<const float*>(x), K},
                 QuantW<Codes>{static_cast<const uint8_t*>(w),
                               static_cast<const float*>(scales), K},
                 StoreY<float>{static_cast<float*>(y), N}, M, N, K, stream);
}

}  // namespace wq
