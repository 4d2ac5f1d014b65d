// The T=1 attention body shared by kernels B1 (t1_attention.cu) and B3
// (t1_attention_block.cu), for Hopper, sm_90a.
//
// One block of kThreads threads per (stream, head) calls one of the two
// bodies below once. With q_u in shared memory (f32) and pm[s] the
// position term of slot s (relative-position score * scale + additive
// window/validity mask; -1e9 on dead slots, whose weight underflows to
// exactly 0):
//     scores  = (q_u . K_buf[s]) * scale + pm[s],  s < S_buf
//               (q_u . k_new)    * scale + pm[S_buf]
//     w       = softmax(scores)                  (f32, over S_buf + 1)
//     out     = sum_s w[s] V_buf[s] + w[S_buf] v_new
// K_buf / V_buf are the (stream, head)'s [S_buf, Dh] cache rows (read only).
// Types: TN the new frame's k_new / v_new, TC the dense cache element, TO
// the output (float or __nv_bfloat16 each); every sum is f32.
//
// attend_dense: each warp takes a strided share of the history slots and
// reduces the Dh dot product with shuffles (lanes read neighbouring
// elements, so each row load is coalesced); the last warp scores the new
// frame; thread d then accumulates sum_s w[s] V[s, d] (a warp reads a
// contiguous segment of each V row) and normalises once.
//
// attend_i8 (int8 QuantKV caches, JAX ops/rel_attention.py _t1_scores /
// _t1_context): K/V codes [S_buf, Dh] int8 with one f32 scale per frame.
// The K scale multiplies a score after the Dh reduction, the V scale folds
// into the softmax weight (after the softmax sum, so the normaliser is that
// of the unscaled weights), and nothing dequantized is ever written. A
// 128-byte code row is one coalesced warp load of 4 bytes per lane: lane l
// owns d = 4l..4l+3 (Dh <= 128, Dh % 4 == 0), and a warp loads kUnroll rows
// before it reduces any, so the loads overlap. For the context each warp
// sums its strided share of the slots in registers, and the kWarps partial
// rows meet in shared memory.
//
// Shared memory the caller provides: w_s [S_buf + 1], red [kWarps], and for
// attend_i8 part [kWarps * Dh]. Both bodies end without a barrier after
// their last shared-memory read, so a caller that reuses that memory
// synchronises first.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace t1 {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // int8 history rows a warp loads together

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The new frame's score, by the last warp: w_s[s_buf].
template <typename TN>
__device__ __forceinline__ void score_new(const float* q_s, const TN* kn,
                                          const float* pm, float* w_s,
                                          int s_buf, int d_head, float scale) {
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) != kWarps - 1) return;
  float acc = 0.f;
  for (int d = lane; d < d_head; d += 32) acc = fmaf(q_s[d], to_f32(kn[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) w_s[s_buf] = acc * scale + pm[s_buf];
}

// Softmax over w_s[0 .. s_buf] in place: the max, then exp. The slots below
// s_buf are multiplied by v_scale[s] when v_scale is given (int8 V). Returns
// 1 / (sum of the unscaled exp weights) to every thread.
__device__ __forceinline__ float softmax_(float* w_s, float* red, int s_buf,
                                          const float* v_scale) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float m = -INFINITY;
  for (int s = tid; s <= s_buf; s += kThreads) m = fmaxf(m, w_s[s]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
  __syncthreads();  // every thread has read red before it is reused

  float sum = 0.f;
  for (int s = tid; s <= s_buf; s += kThreads) {
    const float e = expf(w_s[s] - m);  // masked slots: exactly 0
    w_s[s] = (v_scale != nullptr && s < s_buf) ? e * v_scale[s] : e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = 0.f;
  for (int i = 0; i < kWarps; ++i) sum += red[i];
  return 1.f / sum;
}

template <typename TN, typename TC, typename TO>
__device__ __forceinline__ void attend_dense(
    const float* q_s, const TN* __restrict__ kn, const TN* __restrict__ vn,
    const float* pm, const TC* __restrict__ kb, const TC* __restrict__ vb,
    TO* __restrict__ out, int s_buf, int d_head, float scale, float* w_s,
    float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int s = warp; s < s_buf; s += kWarps) {
    const TC* row = kb + (long)s * d_head;
    float acc = 0.f;
    for (int d = lane; d < d_head; d += 32) acc = fmaf(q_s[d], to_f32(row[d]), acc);
    acc = warp_sum(acc);
    if (lane == 0) w_s[s] = acc * scale + pm[s];
  }
  score_new(q_s, kn, pm, w_s, s_buf, d_head, scale);
  __syncthreads();

  const float inv = softmax_(w_s, red, s_buf, nullptr);

  // context: thread d walks the slots down column d of V
  for (int d = tid; d < d_head; d += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < s_buf; ++s)
      acc = fmaf(w_s[s], to_f32(vb[(long)s * d_head + d]), acc);
    acc = fmaf(w_s[s_buf], to_f32(vn[d]), acc);
    out[d] = from_f32<TO>(acc * inv);
  }
}

template <typename TN, typename TO>
__device__ __forceinline__ void attend_i8(
    const float* q_s, const TN* __restrict__ kn, const TN* __restrict__ vn,
    const float* pm, const int8_t* __restrict__ k_q,
    const float* __restrict__ k_s, const int8_t* __restrict__ v_q,
    const float* __restrict__ v_s, TO* __restrict__ out, int s_buf,
    int d_head, float scale, float* w_s, float* red, float* part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d4 = d_head / 4;  // code groups per row; lane < d4 owns one
  const char4* kb = reinterpret_cast<const char4*>(k_q);
  const char4* vb = reinterpret_cast<const char4*>(v_q);

  // content scores of the int8 history rows: a warp takes kUnroll rows at
  // a time, so that their loads are in flight together
  float q4[4] = {0.f, 0.f, 0.f, 0.f};
  if (lane < d4)
    for (int j = 0; j < 4; ++j) q4[j] = q_s[4 * lane + j];
  for (int s0 = warp * kUnroll; s0 < s_buf; s0 += kWarps * kUnroll) {
    char4 k4[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      k4[u] = (lane < d4 && s0 + u < s_buf) ? kb[(long)(s0 + u) * d4 + lane]
                                            : make_char4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float acc = q4[0] * (float)k4[u].x;
      acc = fmaf(q4[1], (float)k4[u].y, acc);
      acc = fmaf(q4[2], (float)k4[u].z, acc);
      acc = fmaf(q4[3], (float)k4[u].w, acc);
      acc = warp_sum(acc);
      const int s = s0 + u;
      if (lane == 0 && s < s_buf)  // K scale after the Dh reduction
        w_s[s] = acc * k_s[s] * scale + pm[s];
    }
  }
  score_new(q_s, kn, pm, w_s, s_buf, d_head, scale);
  __syncthreads();

  const float inv = softmax_(w_s, red, s_buf, v_s);

  // context: warp w sums slots w, w + kWarps, ...; lane l owns 4 columns
  if (lane < d4) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
    for (int s = warp; s < s_buf; s += kWarps) {
      const char4 v4 = vb[(long)s * d4 + lane];
      const float w = w_s[s];
      a0 = fmaf(w, (float)v4.x, a0);
      a1 = fmaf(w, (float)v4.y, a1);
      a2 = fmaf(w, (float)v4.z, a2);
      a3 = fmaf(w, (float)v4.w, a3);
    }
    float* p = part + warp * d_head + 4 * lane;
    p[0] = a0;
    p[1] = a1;
    p[2] = a2;
    p[3] = a3;
  }
  __syncthreads();
  for (int d = tid; d < d_head; d += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < kWarps; ++i) acc += part[i * d_head + d];
    acc = fmaf(w_s[s_buf], to_f32(vn[d]), acc);
    out[d] = from_f32<TO>(acc * inv);
  }
}

}  // namespace t1
