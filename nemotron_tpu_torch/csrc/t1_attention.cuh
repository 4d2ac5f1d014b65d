// The T=1 attention body shared by kernels B1 (t1_attention.cu) and B3's
// attention launch (t1_attention_block.cu), for Hopper, sm_90a.
//
// For one (stream, head), with q_u in shared memory (f32) and pm[s] the
// position term of slot s (relative-position score * scale + additive
// window/validity mask; -1e9 on dead slots, whose weight underflows to
// exactly 0):
//     scores  = (q_u . K_buf[s]) * scale + pm[s],  s < S_buf
//               (q_u . k_new)    * scale + pm[S_buf]
//     w       = softmax(scores)                  (f32, over S_buf + 1)
//     out     = sum_s w[s] V_buf[s] + w[S_buf] v_new
// int8 QuantKV caches (JAX ops/rel_attention.py _t1_scores / _t1_context)
// hold codes with one f32 scale per frame: the K scale multiplies a score
// after the Dh reduction, the V scale folds into the softmax weight (after
// the softmax sum, so the normaliser is that of the unscaled weights), and
// nothing dequantized is ever written. The caches are read only.
//
// What bounds it on the H100: the bytes of K_buf and V_buf, read once
// (2 * S_buf * Dh elements per (stream, head); 40 KB in bf16 at S_buf 78,
// Dh 128), over 3.35 TB/s. Design:
//   * The caller copies the (stream, head)'s K rows and V rows into shared
//     memory with two one-dimensional bulk copies (hopper_async.cuh), each
//     completing on its own mbarrier, issued ahead of the pair's work, and
//     stages its small inputs (q, k_new, v_new, position terms, int8
//     scales) beside them on K's barrier: scoring starts once K has landed
//     while V is still arriving, and the pair's work reads shared memory
//     only (a global load's latency per input, in a chain, cost more than
//     the copies did). A row is Dh * sizeof(TC) bytes, Dh in {16, 32, 64,
//     128}: a power-of-two count of 16-byte chunks (the wrappers check).
//   * Shared memory is read in 16-byte vectors (Chunk<TC>: 4 f32, 8 bf16
//     or 16 int8 values per lane). A row is L = Dh / kN lanes: a warp
//     scores 32 / L rows per load (two bf16 rows of 128) and reduces within
//     groups of L lanes; kUnroll row loads are issued before any reduction.
//   * Context: lane j of a row group owns chunk j (kN columns); the warps'
//     row groups take strided slots, sum in registers, and their 128 / L
//     partial rows meet in shared memory, summed in a fixed order.
//   * The body returns the softmax's max m, its sum l and thread d's
//     unnormalised context o[d], so a caller that splits the slots over
//     the blocks of a cluster combines the partial (m, l, o) exactly as
//     softmax's own rescaling does (t1_attention.cu).
// The body is one group of kThreads threads; a block may hold several
// groups, each with its own barrier id (group_sync) and shared memory:
// w_s [n + 1], red [kWarps], part [128 * kN] f32. The body synchronises its
// group; a caller that reuses that memory for the next pair synchronises
// first. The head width kDh is a template parameter (16, 32, 64 or 128),
// so the per-row lane count and the shuffle trees are unrolled.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_async.cuh"

namespace t1 {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // row loads a lane issues before it reduces
// measurement only (tools/gemm_turns.py --probe builds these variants):
// bit 1 leaves out the scores and the context, bit 2 the copies and their
// waits; 0 in every build of the kernels
#ifndef T1_PROBE
#define T1_PROBE 0
#endif
constexpr int kProbe = T1_PROBE;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of a cache row as kN f32 values
template <typename TC>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void get(uint4 u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void get(uint4 u, float* v) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift, exact
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// int8 codes to f32 exactly without I2F (a quarter-rate unit, and 16
// conversions per lane and row here): byte b of a word, offset by 128 (x ^
// 0x80), placed under the exponent of 2^23 reads as 2^23 + 128 + code
template <>
struct Chunk<int8_t> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void get(uint4 u, float* v) {
    const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                           u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v[4 * i + b] =
            __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 | b)) -
            8388736.0f;  // 2^23 + 128
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the barrier of one group of kThreads threads (whole warps): id 0 with a
// block of kThreads is __syncthreads; a block of several groups gives
// each its own id
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

// scores of the n rows landed in kt ([n][kDh] TC) into w_s[0 .. n):
// (q . K[s]) (* ks[s] for int8) * scale + pm[s]; tid is the thread's index
// in its group
template <typename TC, int kDh, typename TQ>
__device__ __forceinline__ void score_rows(int tid, const TQ* q_s,
                                           const uint8_t* kt, const float* ks,
                                           const float* pm, float* w_s, int n,
                                           float scale) {
  constexpr int kN = Chunk<TC>::kN;
  constexpr int L = kDh / kN, R = 32 / L;  // lanes per row, rows per load
  constexpr int kStep = kWarps * R, kRowB = kDh * (int)sizeof(TC);
  const int lane = tid & 31, warp = tid >> 5;
  const int j = lane % L, g = lane / L;
  float qr[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) qr[i] = to_f32(q_s[j * kN + i]);
  for (int base = warp * R; base < n; base += kStep * kUnroll) {
    uint4 c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + u * kStep + g;
      c[u] = s < n ? *reinterpret_cast<const uint4*>(kt + s * kRowB + j * 16)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[kN];
      Chunk<TC>::get(c[u], v);
      acc[u] = 0.f;
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[u] = fmaf(qr[i], v[i], acc[u]);
    }
#pragma unroll
    for (int o = L >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + u * kStep + g;
      if (j == 0 && s < n)  // int8: the K scale after the Dh reduction
        w_s[s] = (ks != nullptr ? acc[u] * ks[s] : acc[u]) * scale + pm[s];
    }
  }
}

// the new frame's score, by the group's last warp, into *w_new
template <int kDh, typename TQ, typename TN>
__device__ __forceinline__ void score_new(int tid, const TQ* q_s,
                                          const TN* kn, float pm_new,
                                          float* w_new, float scale) {
  const int lane = tid & 31;
  if ((tid >> 5) != kWarps - 1) return;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < kDh; d += 32)
    acc = fmaf(to_f32(q_s[d]), to_f32(kn[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) *w_new = acc * scale + pm_new;
}

// softmax over w_s[0 .. cnt) in place: the max (into m), then exp; the
// slots below n are multiplied by v_scale[s] when v_scale is given (int8
// V). Returns the sum of the unscaled exp weights to every thread of the
// group (red: kWarps floats of the group's own).
__device__ __forceinline__ float softmax_(int tid, int bar, float* w_s,
                                          float* red, int cnt, int n,
                                          const float* v_scale, float& m) {
  const int lane = tid & 31, warp = tid >> 5;
  m = -INFINITY;
  for (int s = tid; s < cnt; s += kThreads) m = fmaxf(m, w_s[s]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  group_sync(bar);
  m = red[0];
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
  group_sync(bar);  // every thread has read red before it is reused

  float sum = 0.f;
  for (int s = tid; s < cnt; s += kThreads) {
    const float e = expf(w_s[s] - m);  // masked slots: exactly 0
    w_s[s] = (v_scale != nullptr && s < n) ? e * v_scale[s] : e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  group_sync(bar);
  sum = 0.f;
  for (int i = 0; i < kWarps; ++i) sum += red[i];
  return sum;
}

// sum_s w_s[s] V[s] over the n rows landed in vt, as 128 / L partial rows
// of kDh f32 in part
template <typename TC, int kDh>
__device__ __forceinline__ void context_rows(int tid, const uint8_t* vt,
                                             const float* w_s, int n,
                                             float* part) {
  constexpr int kN = Chunk<TC>::kN;
  constexpr int L = kDh / kN, R = 32 / L;
  constexpr int kStep = kWarps * R, kRowB = kDh * (int)sizeof(TC);
  const int lane = tid & 31, warp = tid >> 5;
  const int j = lane % L, g = lane / L;
  float acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.f;
  for (int base = warp * R; base < n; base += kStep * kUnroll) {
    uint4 c[kUnroll];
    float w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + u * kStep + g;
      const bool ok = s < n;
      c[u] = ok ? *reinterpret_cast<const uint4*>(vt + s * kRowB + j * 16)
                : make_uint4(0u, 0u, 0u, 0u);
      w[u] = ok ? w_s[s] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[kN];
      Chunk<TC>::get(c[u], v);
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] = fmaf(w[u], v[i], acc[i]);
    }
  }
  float4* p = reinterpret_cast<float4*>(part + (warp * R + g) * kDh + j * kN);
#pragma unroll
  for (int i = 0; i < kN / 4; ++i)
    p[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
}

// The softmax's max m and sum l over this group's slots, and thread d's
// unnormalised context o (d < kDh; 0 elsewhere).
struct Partial {
  float m, l, o;
};

// One (stream, head) over n slots, by one group of kThreads threads (tid:
// the thread's index in the group, bar: the group's barrier id), whose K
// rows (kt) and V rows (vt) are being copied into shared memory,
// completing on bar_k / bar_v in the phase of this parity (a caller that
// stages q, k_new, v_new, pm, ks or vs in shared memory completes them on
// bar_k too); every pointer is to shared memory. pm [n + 1]: the slots'
// position terms and, at n, the new frame's; has_new adds the new frame
// (k_new, v_new). ks / vs: the int8 caches' per-frame scales of these
// slots (nullptr for dense caches).
template <typename TC, int kDh, typename TQ, typename TN>
__device__ __forceinline__ Partial attend(
    int tid, int bar, const TQ* q_s, const TN* kn, const TN* vn,
    const float* pm, const uint8_t* kt, const uint8_t* vt, const float* ks,
    const float* vs, int n, bool has_new, float scale, uint64_t* bar_k,
    uint64_t* bar_v, uint32_t parity, float* w_s, float* red, float* part) {
  if (!(kProbe & 2)) hopper::bar_wait(bar_k, parity);
  if (!(kProbe & 1))
    score_rows<TC, kDh>(tid, q_s, kt, ks, pm, w_s, n, scale);
  if (has_new) score_new<kDh>(tid, q_s, kn, pm[n], w_s + n, scale);
  group_sync(bar);

  Partial r;
  r.l = softmax_(tid, bar, w_s, red, n + (has_new ? 1 : 0), n, vs, r.m);

  if (!(kProbe & 2)) hopper::bar_wait(bar_v, parity);
  if (!(kProbe & 1)) context_rows<TC, kDh>(tid, vt, w_s, n, part);
  group_sync(bar);
  r.o = 0.f;
  if (tid < kDh) {
    constexpr int kRows = kThreads * Chunk<TC>::kN / kDh;  // 128 / L
    float a0 = 0.f, a1 = 0.f;  // two chains, added in a fixed order
#pragma unroll
    for (int i = 0; i < kRows; i += 2) {
      a0 += part[i * kDh + tid];
      if (i + 1 < kRows) a1 += part[(i + 1) * kDh + tid];
    }
    float acc = a0 + a1;
    if (has_new) acc = fmaf(w_s[n], to_f32(vn[tid]), acc);
    r.o = acc;
  }
  return r;
}

// Calls f with the compile-time head width (the wrappers take 16, 32, 64
// or 128); returns cudaErrorInvalidValue for another
template <class F>
int with_d_head(int d_head, F&& f) {
  switch (d_head) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of one copy of a (stream, head)'s n rows, as laid out in shared
// memory: K then V, each rounded to 128 bytes.
__host__ __device__ inline int tile_bytes(int n, int d_head, int elem) {
  return (n * d_head * elem + 127) / 128 * 128;
}

}  // namespace t1
