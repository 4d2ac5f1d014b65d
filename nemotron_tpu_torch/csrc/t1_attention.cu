// B1: T=1 streaming attention core (80 ms mode, chunk_len 1) for Hopper,
// sm_90a.
//
// Replaces: nemotron_tpu/ops/attn_pallas.py, _attn_kernel via
// t1_attention_core (pallas_call at :84). Same function, not the same grid:
// for each (stream, head)
//     scores  = (q_u . K_buf[s]) * scale + pos_mask[s],  s < S_buf
//               (q_u . k_new)    * scale + pos_mask[S_buf]
//     w       = softmax(scores)                  (f32, over S_buf + 1)
//     ctx     = sum_s w[s] V_buf[s] + w[S_buf] v_new
// pos_mask already holds the phase-shifted relative-position scores times
// the scale plus the additive window/validity mask.
//
// What bounds it on the H100: device-memory bandwidth. Each (stream, head)
// reads 2 * S_buf * Dh cache elements once (2*78*128*4 B = 80 KB in f32)
// and does 2 FMAs per element; at T=1 there is no reuse to exploit, so the
// floor is (bytes of K_buf + V_buf) / 3.35 TB/s.
//
// Design (a first version: simple and right; TMA / wider loads later): one
// block of 128 threads per (stream, head); q_u goes to shared memory as f32,
// then the body shared with B3 (t1_attention.cuh) scores, normalises and
// sums. The cache is read-only here: the caller appends the new frame.
// Element type: float or __nv_bfloat16 (q, k_new, v_new, caches, output);
// all sums are f32.
//
// int8 caches (t1_attention_i8_*): K/V codes [B*H, S_buf, Dh] int8 with one
// f32 scale per frame [B*H, S_buf], read as they are (t1::attend_i8); q,
// k_new, v_new and the output stay in the activation type. Loading a warp's
// int8 rows four at a time took a launch from 48.9 us (863 GB/s) at B=256
// to 37-38 us. The bytes read per (stream, head) drop from 2*S_buf*Dh*4
// (f32) to 2*S_buf*(Dh + 4).

#include "t1_attention.cuh"

namespace {

using t1::kThreads;
using t1::kWarps;

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
  for (int d = threadIdx.x; d < d_head; d += kThreads)
    q_s[d] = t1::to_f32(q[bh * d_head + d]);
  __syncthreads();
  t1::attend_dense(q_s, k_new + bh * d_head, v_new + bh * d_head,
                   pos_mask + bh * (long)(s_buf + 1),
                   k_buf + bh * (long)s_buf * d_head,
                   v_buf + bh * (long)s_buf * d_head, out + bh * d_head,
                   s_buf, d_head, scale, w_s, red);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
t1_attention_i8_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                       const T* __restrict__ v_new,
                       const float* __restrict__ pos_mask,
                       const int8_t* __restrict__ k_q,
                       const float* __restrict__ k_s,
                       const int8_t* __restrict__ v_q,
                       const float* __restrict__ v_s, T* __restrict__ out,
                       int s_buf, int d_head, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // [d_head]
  float* w_s = smem + d_head;         // [s_buf + 1] scores, then weights
  float* part = w_s + s_buf + 1;      // [kWarps][d_head] context partials
  __shared__ float red[kWarps];

  const long bh = blockIdx.x;  // stream * H + head
  for (int d = threadIdx.x; d < d_head; d += kThreads)
    q_s[d] = t1::to_f32(q[bh * d_head + d]);
  __syncthreads();
  t1::attend_i8(q_s, k_new + bh * d_head, v_new + bh * d_head,
                pos_mask + bh * (long)(s_buf + 1),
                k_q + bh * (long)s_buf * d_head, k_s + bh * (long)s_buf,
                v_q + bh * (long)s_buf * d_head, v_s + bh * (long)s_buf,
                out + bh * d_head, s_buf, d_head, scale, w_s, red, part);
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

template <typename T>
int launch_i8(const void* q, const void* k_new, const void* v_new,
              const void* pos_mask, const void* k_q, const void* k_s,
              const void* v_q, const void* v_s, void* out, int batch_heads,
              int s_buf, int d_head, float scale, void* stream) {
  if (batch_heads <= 0) return 0;
  const size_t smem =
      sizeof(float) * (size_t)(d_head + s_buf + 1 + kWarps * d_head);
  t1_attention_i8_kernel<T><<<batch_heads, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const float*>(pos_mask),
      static_cast<const int8_t*>(k_q), static_cast<const float*>(k_s),
      static_cast<const int8_t*>(v_q), static_cast<const float*>(v_s),
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

extern "C" int t1_attention_i8_f32(const void* q, const void* k_new,
                                   const void* v_new, const void* pos_mask,
                                   const void* k_q, const void* k_s,
                                   const void* v_q, const void* v_s,
                                   void* out, int batch_heads, int s_buf,
                                   int d_head, float scale, void* stream) {
  return launch_i8<float>(q, k_new, v_new, pos_mask, k_q, k_s, v_q, v_s, out,
                          batch_heads, s_buf, d_head, scale, stream);
}

extern "C" int t1_attention_i8_bf16(const void* q, const void* k_new,
                                    const void* v_new, const void* pos_mask,
                                    const void* k_q, const void* k_s,
                                    const void* v_q, const void* v_s,
                                    void* out, int batch_heads, int s_buf,
                                    int d_head, float scale, void* stream) {
  return launch_i8<__nv_bfloat16>(q, k_new, v_new, pos_mask, k_q, k_s, v_q,
                                  v_s, out, batch_heads, s_buf, d_head, scale,
                                  stream);
}
