// T=1 streaming attention core (80 ms mode, chunk_len 1) for Hopper, sm_90a.
//
// Replaces: nemotron_tpu/ops/attn_pallas.py, _attn_kernel via
// t1_attention_core (pallas_call at :84). Same function, not the same grid:
// for each (stream, head)
//     scores  = (q_u . K_buf[s]) * scale + pos_mask[s],  s < S_buf
//               (q_u . k_new)    * scale + pos_mask[S_buf]
//     w       = softmax(scores)                  (f32, over S_buf + 1)
//     ctx     = sum_s w[s] V_buf[s] + w[S_buf] v_new
// pos_mask already holds the phase-shifted relative-position scores times
// the scale plus the additive window/validity mask (-1e9 on dead slots,
// whose weight underflows to exactly 0).
//
// What bounds it on the H100: device-memory bandwidth. Each (stream, head)
// reads 2 * S_buf * Dh cache elements once (2*78*128*4 B = 80 KB in f32)
// and does 2 FMAs per element; at T=1 there is no reuse to exploit, so the
// floor is (bytes of K_buf + V_buf) / 3.35 TB/s.
//
// Design (a first version: simple and right; TMA / wider loads later):
//   * one block per (stream, head), 128 threads = 4 warps;
//   * q_u goes to shared memory as f32;
//   * each warp takes a strided share of the S_buf + 1 slots and reduces
//     the Dh dot product with shuffles (lanes read neighbouring elements,
//     so each row load is coalesced); the scores sit in shared memory;
//   * softmax max/sum are block reductions in f32;
//   * thread d then accumulates sum_s w[s] V[s, d] (a warp reads a
//     contiguous 128-byte segment of each V row) and normalises once.
// The cache is read-only here: the caller appends the new frame.
// Element type: float or __nv_bfloat16 (q, k_new, v_new, caches, output);
// all sums are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
t1_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                    const T* __restrict__ v_new,
                    const float* __restrict__ pos_mask,
                    const T* __restrict__ k_buf, const T* __restrict__ v_buf,
                    T* __restrict__ out, int s_buf, int d_head, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;           // [d_head]
  float* w_s = smem + d_head;  // [s_buf + 1] scores, then exp weights
  __shared__ float red[kWarps];

  const long bh = blockIdx.x;  // stream * H + head
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* kb = k_buf + bh * (long)s_buf * d_head;
  const T* vb = v_buf + bh * (long)s_buf * d_head;
  const T* kn = k_new + bh * d_head;
  const T* vn = v_new + bh * d_head;
  const float* pm = pos_mask + bh * (long)(s_buf + 1);

  for (int d = tid; d < d_head; d += kThreads) q_s[d] = to_f32(q[bh * d_head + d]);
  __syncthreads();

  // content scores: slot s_buf is the new frame
  for (int s = warp; s <= s_buf; s += kWarps) {
    const T* row = (s < s_buf) ? kb + (long)s * d_head : kn;
    float acc = 0.f;
    for (int d = lane; d < d_head; d += 32) acc = fmaf(q_s[d], to_f32(row[d]), acc);
    acc = warp_sum(acc);
    if (lane == 0) w_s[s] = acc * scale + pm[s];
  }
  __syncthreads();

  // softmax in f32: block max, then exp and block sum
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
    w_s[s] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = 0.f;
  for (int i = 0; i < kWarps; ++i) sum += red[i];
  const float inv = 1.f / sum;

  // context: thread d walks the slots down column d of V
  for (int d = tid; d < d_head; d += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < s_buf; ++s)
      acc = fmaf(w_s[s], to_f32(vb[(long)s * d_head + d]), acc);
    acc = fmaf(w_s[s_buf], to_f32(vn[d]), acc);
    out[bh * d_head + d] = from_f32<T>(acc * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* pos_mask, const void* k_buf, const void* v_buf,
           void* out, int batch_heads, int s_buf, int d_head, float scale,
           void* stream) {
  if (batch_heads <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)(d_head + s_buf + 1);
  t1_attention_kernel<T><<<batch_heads, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const float*>(pos_mask),
      static_cast<const T*>(k_buf), static_cast<const T*>(v_buf),
      static_cast<T*>(out), s_buf, d_head, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int t1_attention_f32(const void* q, const void* k_new,
                                const void* v_new, const void* pos_mask,
                                const void* k_buf, const void* v_buf,
                                void* out, int batch_heads, int s_buf,
                                int d_head, float scale, void* stream) {
  return launch<float>(q, k_new, v_new, pos_mask, k_buf, v_buf, out,
                       batch_heads, s_buf, d_head, scale, stream);
}

extern "C" int t1_attention_bf16(const void* q, const void* k_new,
                                 const void* v_new, const void* pos_mask,
                                 const void* k_buf, const void* v_buf,
                                 void* out, int batch_heads, int s_buf,
                                 int d_head, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_new, v_new, pos_mask, k_buf, v_buf, out,
                               batch_heads, s_buf, d_head, scale, stream);
}
