// GEMM body for Hopper, sm_90a, with f32 activations: kernels B4
// (q8_matmul.cu, Q8_0) and B5 (q4_matmul.cu, Q4_0) in f32, and the two
// projections of B3 (t1_attention_block.cu) in f32. Every bf16 form (B4,
// B5, B3's projections) runs on wq_gemm_sm90.cuh instead.
//
//     y[m, n] = epilogue(m, n, sum_k a(m, k) * w(n, k))
//
// Three policies make one kernel serve all of them:
//   * the A loader gives a(m, k): PlainA reads x [M, K] row-major; LnA
//     reads x and applies a layer norm from row statistics (mean,
//     1/sqrt(var + eps), f32, population variance) that ln_stats computes
//     once per row, two passes over the row as the reference formula, so
//     the normalised rows never reach memory;
//   * the weight loader fetches 8 values of row n from k0 (k0 % 8 == 0)
//     raw and converts them to f32: QuantW dequantizes Q8_0 / Q4_0 codes
//     (`Codes::fetch` reads the integer codes, `Codes::unpack` makes them
//     f32, times the per-32-input scale [N, K/32]); DenseW reads up to
//     three row-major [rows, K] matrices stacked along N;
//   * the epilogue stores y[m, n] from the f32 sum (StoreY, or AddResidual:
//     added to a residual), or each K split's sum into its own slice
//     (StoreSplits, which B3's attention launch adds in split order).
//
// What bounds it on the H100: at the serving shapes (M = B <= 256 streams,
// N, K in 1024..4096) one call reads the weight once and does 2*M*N*K
// flops in full f32 FFMA on the CUDA cores (67 TFLOP/s; no TF32 and no
// tensor-core emulation of f32: f32 is the parity form), so the flops bind
// from M ~ 16 up: 32 us for (4096, 1024) at M = 256.
//
// Design, to keep the FP32 pipes fed:
//   * Block tiles of BM x 128 outputs (BM 128, or 64 where the batch is
//     ragged or small), 256 threads, 8 x 8 (BM 64: 4 x 8) outputs per
//     thread in quadrants of 4 x 4 that lie 64 rows / columns apart. Per k
//     a thread reads its A and B fragments as 16-byte shared loads (a warp
//     covers 4 x 8 threads: 4 distinct A and 8 distinct B vectors, no bank
//     conflict) and does 64 FFMAs per four loads. B3's QKV (LnA) runs the
//     k loop as 16-step unrolled bodies with the next k's fragments loaded
//     ahead, which measured faster there; the other forms unroll it fully.
//   * K-major tiles of BK = 64 columns in a ring of two shared stages,
//     register-staged: step s+1's raw x rows and weight codes are loaded
//     into registers before step s computes, and converted after it (LN
//     applied, codes dequantized once per element per block, transposed
//     into the tile with 16-byte stores; rows padded by 4 floats so the
//     stores of a quarter warp hit distinct banks). One __syncthreads per
//     step.
//   * A plan (ops/quant.py:f32_plan, memoized) gives the batch tile and the
//     split-K from (M, N, K, SMs): the least time of a cost model fitted
//     to the measured plans, within one wave of one block per SM. The
//     splits of B4 / B5 and of B3's out projection write f32 partials to a
//     workspace; the last block of a tile to arrive (a per-tile counter the
//     wrapper allocates once, which that block resets to 0) adds them in
//     split order and applies the epilogue: no extra launch, and two calls
//     give the same bits. B3's QKV splits go to their own slices instead.
//   * Each launch is a programmatic dependent launch: the grid is set up
//     while the stream's previous kernel drains, and waits for it before
//     it reads anything.
//   * Ragged M, N and K are masked in the loads and the stores: the
//     wrapper never pads, and rows past M or N and columns past K read as
//     zero.
// What holds it back (tools/gemm_turns.py --probe=f32, PERF.md): the math
// alone runs at ~0.6 of the FFMA peak at M = 256 (a fixed ~10 us per call
// for the ring's fill, the split reduction and the launch, and the loop
// itself), and the staged loads, though issued before each step's math,
// still land late and add ~20% to it.
// The wrappers check K % 32 == 0 (K % 64 == 0 for Q4), 16-byte aligned
// rows, contiguous weights.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"


// measurement only (tools/gemm_turns.py --probe builds these variants):
// bit 1 leaves out the staging of every step after the first, bit 2 the
// math of all but one column of each step; 0 in every build of the kernels
#ifndef WQ_F32_PROBE
#define WQ_F32_PROBE 0
#endif

namespace wq {

constexpr int QB = 32;  // inputs per quantization block (one scale)

// ---- 8 consecutive f32 values: fetched raw, unpacked later ----------------
// Every global read of the operands goes through __ldg, the read-only
// path: the policies below hold plain pointers, which the compiler cannot
// prove unaliased as it could the kernels' __restrict__ arguments.

struct Raw8 {
  float4 lo, hi;
};

__device__ __forceinline__ Raw8 ld8(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return Raw8{__ldg(q), __ldg(q + 1)};
}

__device__ __forceinline__ void unpack8(const Raw8& r, float* v) {
  v[0] = r.lo.x;
  v[1] = r.lo.y;
  v[2] = r.lo.z;
  v[3] = r.lo.w;
  v[4] = r.hi.x;
  v[5] = r.hi.y;
  v[6] = r.hi.z;
  v[7] = r.hi.w;
}

// ---- A loaders: fetch(m, k) reads a(m, k .. k+8) raw; convert(raw, st,
// cols(k), v) fills v[0..8) as f32 (st: the row's LN statistics and cols:
// the columns' LN weights, LnA only) ---------------------------------------

struct PlainA {
  const float* x;
  int K;
  static constexpr bool kLn = false;
  struct Cols {};
  __device__ Raw8 fetch(int m, int k) const { return ld8(x + (long)m * K + k); }
  __device__ Cols cols(int) const { return {}; }
  __device__ void convert(const Raw8& r, float2, const Cols&, float* v) const {
    unpack8(r, v);
  }
};

struct LnA {
  const float* x;
  const float* ln_w;
  const float* ln_b;
  const float2* stats;  // [M] (mean, 1/sqrt(var + eps)), from ln_stats
  int K;
  static constexpr bool kLn = true;
  struct Cols {  // ln_w, ln_b at the 8 columns
    Raw8 g, b;
  };
  __device__ Raw8 fetch(int m, int k) const { return ld8(x + (long)m * K + k); }
  __device__ Cols cols(int k) const { return {ld8(ln_w + k), ld8(ln_b + k)}; }
  __device__ void convert(const Raw8& r, float2 s, const Cols& c,
                          float* v) const {
    float g[8], b[8];
    unpack8(r, v);
    unpack8(c.g, g);
    unpack8(c.b, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] - s.x) * s.y * g[j] + b[j];
  }
};

// mean and 1/sqrt(var + eps) of each row of x [M, K] into st[M], one warp
// per row, two passes over the row (the second from L1) as the reference
// formula; once per call, so no block of the GEMM repeats them
static __global__ void __launch_bounds__(256)
ln_stats(const float* __restrict__ x, float2* __restrict__ st, int M, int K,
         float eps) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= M) return;
  const float* row = x + (long)m * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += row[k];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = s / K;
  float q = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = row[k] - mu;
    q = fmaf(d, d, q);
  }
  for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  if (lane == 0) st[m] = make_float2(mu, 1.f / sqrtf(q / K + eps));
}

inline int run_ln_stats(const float* x, float2* st, int M, int K, float eps,
                        cudaStream_t stream) {
  if (M <= 0) return 0;
  ln_stats<<<(M + 7) / 8, 256, 0, stream>>>(x, st, M, K, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---- weight loaders: fetch(n, k0) reads w(n, k0 .. k0+8) raw;
// convert(raw, k0, c) fills c[0..8) as f32 ---------------------------------

template <class Codes>
struct QuantW {
  const uint8_t* w;
  const float* scales;  // [N, K / QB]
  int K;
  struct Raw {
    typename Codes::Raw c;
    float s;
  };
  __device__ Raw fetch(int n, int k0) const {
    return Raw{Codes::fetch(w, n, K, k0),
               __ldg(scales + (long)n * (K / QB) + k0 / QB)};
  }
  __device__ void convert(const Raw& r, int k0, float* c) const {
    Codes::unpack(r.c, K, k0, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] *= r.s;
  }
};

struct DenseW {
  const float* part[3];  // row n lies in part[n / rows] at row n % rows
  int rows;
  int K;
  using Raw = Raw8;
  __device__ Raw fetch(int n, int k0) const {
    return ld8(part[n / rows] + (long)(n % rows) * K + k0);
  }
  __device__ void convert(const Raw& r, int, float* c) const { unpack8(r, c); }
};

// ---- epilogues -------------------------------------------------------------

struct StoreY {
  float* y;
  int N;
  static constexpr bool kPerSplit = false;
  __device__ void operator()(int m, int n, float acc) const {
    y[(long)m * N + n] = acc;
  }
};

struct AddResidual {  // y = res + acc, summed in f32
  float* y;
  const float* res;
  int N;
  static constexpr bool kPerSplit = false;
  __device__ void operator()(int m, int n, float acc) const {
    const long i = (long)m * N + n;
    y[i] = __ldg(res + i) + acc;
  }
};

struct StoreSplits {  // split z's sums into y[z] of y [splits, M, N]
  float* y;
  int M, N;
  static constexpr bool kPerSplit = true;
  __device__ void operator()(int z, int m, int n, float acc) const {
    y[((long)z * M + m) * N + n] = acc;
  }
};

// ---- the FFMA body ---------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int BN = 128;  // outputs along N per block
constexpr int BK = 64;   // K columns per pipeline step

// how one call is cut (ops/quant.py:f32_plan): batch tile bm, K steps of BK
// in `splits` runs of steps_per; ws [splits, tiles, bm * BN] f32 and
// counters [tiles] (zero between calls) for the in-kernel reduction
struct F32Plan {
  int bm, splits, steps_per;
  float* ws;
  int* counters;
};

template <int BM>
struct Tile {
  static constexpr int TM = BM / 16;  // output rows per thread: 8 or 4
  static constexpr int LDA = BM + 4, LDB = BN + 4;  // padded K-major rows
  static constexpr int kStage = BK * (LDA + LDB);   // floats
  static constexpr int kSmem = 2 * kStage * 4;      // bytes, two stages
};

template <int BM, class A, class W, class E>
__global__ void __launch_bounds__(kF32Threads, 1)
gemm_f32(A a, W w, E e, F32Plan plan, int M, int N, int K) {
  using T = Tile<BM>;
  constexpr int TM = T::TM, LDA = T::LDA, LDB = T::LDB;
  extern __shared__ __align__(16) float smem[];
  // the previous kernel's writes (x, the LN statistics) are visible after
  // this; a no-op when the launch carries no programmatic dependency
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int tiles_n = (N + BN - 1) / BN;
  const int tile = blockIdx.x, z = blockIdx.y;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int steps = (K + BK - 1) / BK;
  const int s0 = z * plan.steps_per;
  const int s1 = min(steps, s0 + plan.steps_per);

  // loads: this thread's 4 rows 4*lr .. 4*lr+3 of the tile and 8 columns
  // kg*8 .. of the step; a quarter warp takes 8 row groups of one column
  // group (its transposed 16-byte stores hit distinct banks)
  const int lr = (tid % 8) + 8 * (tid / 64), kg = (tid / 8) % 8;
  const bool a_role = tid < 2 * BM;  // BM / 4 row groups x 8 column groups
  float2 st[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st[i] = make_float2(0.f, 0.f);
    if constexpr (A::kLn) {
      const int m = m0 + 4 * lr + i;
      if (a_role && m < M) st[i] = a.stats[m];
    }
  }
  Raw8 ra[4];
  typename A::Cols ca{};
  typename W::Raw rw[4];

  auto fetch = [&](int s) {
    const int k = s * BK + kg * 8;
    if (k >= K) return;
    if (a_role) ca = a.cols(k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * lr + i, n = n0 + 4 * lr + i;
      if (a_role && m < M) ra[i] = a.fetch(m, k);
      if (n < N) rw[i] = w.fetch(n, k);
    }
  };
  auto put = [&](int s, float* buf) {
    const int k = s * BK + kg * 8;
    float v[4][8];
    if (a_role) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + 4 * lr + i;
        if (k < K && m < M) {
          a.convert(ra[i], st[i], ca, v[i]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(buf + (kg * 8 + j) * LDA + 4 * lr) =
            make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    }
    float* bs = buf + BK * LDA;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + 4 * lr + i;
      if (k < K && n < N) {
        w.convert(rw[i], k, v[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(bs + (kg * 8 + j) * LDB + 4 * lr) =
          make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
  };

  // math: a warp covers 4 x 8 threads; thread (ty, tx) owns rows
  // q*64 + ty*4 .. +3 and columns q*64 + tx*4 .. +3
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (s0 < s1) {
    fetch(s0);
    put(s0, smem);
  }
  __syncthreads();
  for (int s = s0; s < s1; ++s) {
    const float* cur = smem + ((s - s0) & 1) * T::kStage;
    const bool stage = !(WQ_F32_PROBE & 1) && s + 1 < s1;
    if (stage) fetch(s + 1);  // in flight during the math below
    const float* as = cur + ty * 4;
    const float* bs = cur + BK * LDA + tx * 4;
    auto frag = [&](int k, float* av, float* bv) {
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 t =
            *reinterpret_cast<const float4*>(as + k * LDA + q * 64);
        av[4 * q] = t.x;
        av[4 * q + 1] = t.y;
        av[4 * q + 2] = t.z;
        av[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 t =
            *reinterpret_cast<const float4*>(bs + k * LDB + q * 64);
        bv[4 * q] = t.x;
        bv[4 * q + 1] = t.y;
        bv[4 * q + 2] = t.z;
        bv[4 * q + 3] = t.w;
      }
    };
    if constexpr (A::kLn) {
      // B3's QKV (x rows layer-normed as they enter the ring): a loop of
      // 16-step unrolled bodies with the next k's fragments loaded ahead
      float av[2][TM], bv[2][8];
      frag(0, av[0], bv[0]);
#pragma unroll 16
      for (int k = 0; k < (WQ_F32_PROBE & 2 ? 1 : BK); ++k) {
        if (k + 1 < BK) frag(k + 1, av[(k + 1) & 1], bv[(k + 1) & 1]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[k & 1][i], bv[k & 1][j], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < (WQ_F32_PROBE & 2 ? 1 : BK); ++k) {
        float av[TM], bv[8];
        frag(k, av, bv);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (stage) put(s + 1, smem + ((s + 1 - s0) & 1) * T::kStage);
    __syncthreads();
  }

  // output (i, j) of this thread
  auto row = [&](int i) { return m0 + (i / 4) * 64 + ty * 4 + i % 4; };
  auto col = [&](int j) { return n0 + (j / 4) * 64 + tx * 4 + j % 4; };
  if constexpr (E::kPerSplit) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (row(i) < M && col(j) < N) e(z, row(i), col(j), acc[i][j]);
    return;
  } else {
    if (plan.splits > 1) {
      // this split's partial tile, float4 v of every thread side by side
      const long tile_f4 = BM * BN / 4;
      float4* ws = reinterpret_cast<float4*>(plan.ws);
      float4* mine = ws + ((long)z * gridDim.x + tile) * tile_f4;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          __stcg(mine + (i * 2 + q) * kF32Threads + tid,
                 make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                             acc[i][4 * q + 2], acc[i][4 * q + 3]));
      __threadfence();
      __syncthreads();
      int* last = reinterpret_cast<int*>(smem);  // the ring is free now
      if (tid == 0) {
        const int prev = atomicAdd(plan.counters + tile, 1);
        *last = prev == plan.splits - 1;
        if (*last) plan.counters[tile] = 0;  // ready for the next call
      }
      __syncthreads();
      if (!*last) return;
      __threadfence();
      // the last block of the tile: every split's partial, in split order
      float sum[TM][8];
      for (int zz = 0; zz < plan.splits; ++zz) {
        const float4* p = ws + ((long)zz * gridDim.x + tile) * tile_f4;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float4 t;
            if (zz == z)
              t = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                              acc[i][4 * q + 2], acc[i][4 * q + 3]);
            else
              t = __ldcg(p + (i * 2 + q) * kF32Threads + tid);
            const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              sum[i][4 * q + j] = zz == 0 ? tv[j] : sum[i][4 * q + j] + tv[j];
          }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = sum[i][j];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (row(i) < M && col(j) < N) e(row(i), col(j), acc[i][j]);
  }
}

// ---- launchers -------------------------------------------------------------

template <int BM, class A, class W, class E>
int run_tile(const A& a, const W& w, const E& e, const F32Plan& plan, int M,
             int N, int K, cudaStream_t stream) {
  auto kernel = gemm_f32<BM, A, W, E>;
  static dyn_smem::Limit limit;  // the smem above 48 KB, per device
  if (const cudaError_t err =
          dyn_smem::allow(kernel, Tile<BM>::kSmem, limit, 0))
    return static_cast<int>(err);
  // a programmatic dependent launch: the grid is set up while the previous
  // kernel of the stream drains, and waits for it (griddepcontrol.wait)
  // before it reads anything
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((M + BM - 1) / BM) * ((N + BN - 1) / BN), plan.splits);
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = Tile<BM>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, a, w, e, plan, M, N, K));
}

// refuses a plan that does not cover K once with non-empty splits, or
// splits without the reduction's workspace
template <class A, class W, class E>
int run_f32(const A& a, const W& w, const E& e, const F32Plan& plan, int M,
            int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int steps = (K + BK - 1) / BK;
  if (plan.splits < 1 || plan.steps_per < 1 ||
      (plan.splits - 1) * plan.steps_per >= steps ||
      plan.splits * plan.steps_per < steps ||
      (plan.splits > 1 && !E::kPerSplit && (!plan.ws || !plan.counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  if (plan.bm == 128) return run_tile<128>(a, w, e, plan, M, N, K, st);
  if (plan.bm == 64) return run_tile<64>(a, w, e, plan, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B4 / B5 with f32 x: y = x . dequant(w)^T in f32
template <class Codes>
int launch_f32(const void* x, const void* w, const void* scales, void* y,
               void* ws, void* counters, int M, int N, int K, int bm,
               int splits, int steps_per, void* stream) {
  return run_f32(PlainA{static_cast<const float*>(x), K},
                 QuantW<Codes>{static_cast<const uint8_t*>(w),
                               static_cast<const float*>(scales), K},
                 StoreY{static_cast<float*>(y), N},
                 F32Plan{bm, splits, steps_per, static_cast<float*>(ws),
                         static_cast<int*>(counters)},
                 M, N, K, stream);
}

}  // namespace wq
