// B3: the fused T=1 attention block of one conformer layer for Hopper,
// sm_90a: LN -> Q/K/V projections -> relative-position, new-frame and
// content scores -> softmax -> context -> out projection + residual.
//
// Replaces: nemotron_tpu/ops/attn_block_pallas.py, _block_kernel via
// t1_attention_block (pallas_call at :177). Same function and the same
// rounding points, not the same grid. With D = H * Dh, for each stream b:
//     y       = LN(x[b]) (f32), rounded to x's type
//     q, k, v = y . Wq^T, y . Wk^T, y . Wv^T       (f32 sums; q stays f32)
//   and for each head h:
//     pos[s]  = (q_h + bias_v[h]) . pp[h, :, s]      s <= S_buf
//     scores  = (q_h + bias_u[h]) . K_buf[s] * scale + pos[s] * scale
//               + mask[b, s];  the new frame's with k_h in place of K_buf
//     ctx_h   = softmax(scores) . [V_buf; v_h]       (f32), rounded to x's
//               type
//     out[b]  = x[b] + ctx . Wo^T                    (f32 sum, rounded once)
//   k_new, v_new = k, v rounded to x's type (the caller appends them).
// pp [H, Dh, S_buf + 1] f32 is the phase-shifted position projection, built
// outside the kernel as in the JAX package; mask [B, S_buf + 1] holds 0 on
// live slots and -1e9 on dead ones. The caches are dense (x's type) or int8
// QuantKV codes with one f32 scale per frame, read as they are (the JAX
// package dequantizes first; the values agree up to rounding order).
//
// What bounds it on the H100: the projections read the four [D, D]
// weights (16 MB in f32, 8 MB in bf16 at D = 1024) and do 8*B*D^2 flops;
// the attention reads the caches once (as B1). At B = 256 the f32 GEMMs are
// FFMA-bound (no TF32, by contract), bf16 sits near the tensor cores' ridge.
//
// Design, a first version that is simple and right: one entry call, three
// launches on the caller's stream, intermediates in two scratch buffers the
// wrapper allocates:
//   (a) QKV: the GEMM body of wq_matmul.cuh over N = 3D (the three weights
//       stacked along N by the loader, no copy), its A loader computing the
//       block's LN row statistics first and normalising on load; FFMA for
//       f32, mma.sync with f32 sums for bf16; q, k, v to scratch in f32;
//   (b) one block per (stream, head): q + bias_u, q + bias_v, the position
//       contraction over Dh for every slot (thread s reads pp[h, :, s], so
//       a warp's loads are coalesced), k_new / v_new out, then the T=1
//       attention body shared with B1 (t1_attention.cuh); ctx to scratch in
//       x's type;
//   (c) out: the same GEMM body over ctx, the residual added in the
//       epilogue.
// No library GEMM runs inside: all four projections are computed here.

#include "t1_attention.cuh"
#include "wq_matmul.cuh"

namespace {

using t1::kThreads;
using t1::kWarps;

template <typename T, bool I8>
__global__ void __launch_bounds__(kThreads)
block_attention_kernel(const float* __restrict__ qkv,
                       const T* __restrict__ bias_u,
                       const T* __restrict__ bias_v,
                       const float* __restrict__ pp,
                       const T* __restrict__ mask, const void* kc,
                       const float* __restrict__ k_s, const void* vc,
                       const float* __restrict__ v_s, T* __restrict__ ctx,
                       T* __restrict__ k_new, T* __restrict__ v_new, int H,
                       int s_buf, int d_head, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;               // [d_head] q + bias_u
  float* qv_s = q_s + d_head;      // [d_head] q + bias_v
  float* pm_s = qv_s + d_head;     // [s_buf + 1] pos * scale + mask
  float* w_s = pm_s + s_buf + 1;   // [s_buf + 1] scores, then weights
  float* part = w_s + s_buf + 1;   // int8: [kWarps][d_head]
  __shared__ float red[kWarps];

  const long bh = blockIdx.x;  // stream * H + head
  const long b = bh / H;
  const int h = (int)(bh % H);
  const int D = H * d_head;
  const float* q = qkv + b * 3 * D + h * d_head;
  const float* kn = q + D;
  const float* vn = q + 2 * D;

  for (int d = threadIdx.x; d < d_head; d += kThreads) {
    const float qd = q[d];
    q_s[d] = qd + t1::to_f32(bias_u[h * d_head + d]);
    qv_s[d] = qd + t1::to_f32(bias_v[h * d_head + d]);
    k_new[bh * d_head + d] = t1::from_f32<T>(kn[d]);
    v_new[bh * d_head + d] = t1::from_f32<T>(vn[d]);
  }
  __syncthreads();

  const float* pph = pp + (long)h * d_head * (s_buf + 1);
  const T* mb = mask + b * (s_buf + 1);
  for (int s = threadIdx.x; s <= s_buf; s += kThreads) {
    float acc = 0.f;
    for (int d = 0; d < d_head; ++d)
      acc = fmaf(qv_s[d], pph[(long)d * (s_buf + 1) + s], acc);
    pm_s[s] = acc * scale + t1::to_f32(mb[s]);
  }
  __syncthreads();

  if constexpr (I8) {
    t1::attend_i8(q_s, kn, vn, pm_s,
                  static_cast<const int8_t*>(kc) + bh * s_buf * d_head,
                  k_s + bh * s_buf,
                  static_cast<const int8_t*>(vc) + bh * s_buf * d_head,
                  v_s + bh * s_buf, ctx + bh * d_head, s_buf, d_head, scale,
                  w_s, red, part);
  } else {
    t1::attend_dense(q_s, kn, vn, pm_s,
                     static_cast<const T*>(kc) + bh * s_buf * d_head,
                     static_cast<const T*>(vc) + bh * s_buf * d_head,
                     ctx + bh * d_head, s_buf, d_head, scale, w_s, red);
  }
}

template <typename T>
int gemm(const T* a_x, const T* ln_w, const T* ln_b, float eps,
         const wq::DenseW<T>& w, int M, int N, int K, float* y_f32,
         T* y_res, const T* res, void* stream) {
  // (a) with ln_w: LN on load, f32 out; (c) without: residual epilogue
  if constexpr (sizeof(T) == 4) {
    if (ln_w != nullptr)
      return wq::run_f32(wq::LnA<T>{a_x, ln_w, ln_b, eps, K}, w,
                         wq::StoreY<float>{y_f32, N}, M, N, K, stream);
    return wq::run_f32(wq::PlainA<T>{a_x, K}, w,
                       wq::AddResidual<T>{y_res, res, N}, M, N, K, stream);
  } else {
    if (ln_w != nullptr)
      return wq::run_bf16(wq::LnA<T>{a_x, ln_w, ln_b, eps, K}, w,
                          wq::StoreY<float>{y_f32, N}, M, N, K, stream);
    return wq::run_bf16(wq::PlainA<T>{a_x, K}, w,
                        wq::AddResidual<T>{y_res, res, N}, M, N, K, stream);
  }
}

template <typename T, bool I8>
int launch(const void* x_, const void* ln_w_, const void* ln_b_,
           const void* q_w, const void* k_w, const void* v_w,
           const void* out_w, const void* bias_u, const void* bias_v,
           const void* pp, const void* mask, const void* kc, const void* k_s,
           const void* vc, const void* v_s, void* out, void* k_new,
           void* v_new, void* qkv, void* ctx, int B, int H, int s_buf,
           int d_head, float eps, float scale, void* stream) {
  if (B <= 0) return 0;
  const int D = H * d_head;
  const T* x = static_cast<const T*>(x_);
  const wq::DenseW<T> w_qkv{{static_cast<const T*>(q_w),
                             static_cast<const T*>(k_w),
                             static_cast<const T*>(v_w)}, D, D};
  int err = gemm<T>(x, static_cast<const T*>(ln_w_),
                    static_cast<const T*>(ln_b_), eps, w_qkv, B, 3 * D, D,
                    static_cast<float*>(qkv), nullptr, nullptr, stream);
  if (err) return err;

  const size_t smem = sizeof(float) *
      (size_t)(2 * d_head + 2 * (s_buf + 1) + (I8 ? kWarps * d_head : 0));
  block_attention_kernel<T, I8><<<B * H, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const T*>(bias_u),
      static_cast<const T*>(bias_v), static_cast<const float*>(pp),
      static_cast<const T*>(mask), kc, static_cast<const float*>(k_s), vc,
      static_cast<const float*>(v_s), static_cast<T*>(ctx),
      static_cast<T*>(k_new), static_cast<T*>(v_new), H, s_buf, d_head,
      scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const T* wo = static_cast<const T*>(out_w);
  const wq::DenseW<T> w_out{{wo, wo, wo}, D, D};
  return gemm<T>(static_cast<const T*>(ctx), nullptr, nullptr, 0.f, w_out,
                 B, D, D, nullptr, static_cast<T*>(out), x, stream);
}

}  // namespace

// x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u, bias_v, pp, mask, k_buf,
// v_buf, out, k_new, v_new, qkv scratch [B, 3D] f32, ctx scratch [B, D],
// B, H, S_buf, Dh, eps, scale, stream
#define DENSE_ARGS                                                           \
  const void *x, const void *ln_w, const void *ln_b, const void *q_w,        \
      const void *k_w, const void *v_w, const void *out_w,                   \
      const void *bias_u, const void *bias_v, const void *pp,                \
      const void *mask, const void *k_buf, const void *v_buf, void *out,     \
      void *k_new, void *v_new, void *qkv, void *ctx, int B, int H,          \
      int s_buf, int d_head, float eps, float scale, void *stream
// the same with the int8 caches as codes and scales: k_q, k_s, v_q, v_s
#define I8_ARGS                                                              \
  const void *x, const void *ln_w, const void *ln_b, const void *q_w,        \
      const void *k_w, const void *v_w, const void *out_w,                   \
      const void *bias_u, const void *bias_v, const void *pp,                \
      const void *mask, const void *k_q, const void *k_s, const void *v_q,   \
      const void *v_s, void *out, void *k_new, void *v_new, void *qkv,       \
      void *ctx, int B, int H, int s_buf, int d_head, float eps,             \
      float scale, void *stream

extern "C" int t1_attention_block_f32(DENSE_ARGS) {
  return launch<float, false>(x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u,
                              bias_v, pp, mask, k_buf, nullptr, v_buf,
                              nullptr, out, k_new, v_new, qkv, ctx, B, H,
                              s_buf, d_head, eps, scale, stream);
}

extern "C" int t1_attention_block_bf16(DENSE_ARGS) {
  return launch<__nv_bfloat16, false>(
      x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u, bias_v, pp, mask, k_buf,
      nullptr, v_buf, nullptr, out, k_new, v_new, qkv, ctx, B, H, s_buf,
      d_head, eps, scale, stream);
}

extern "C" int t1_attention_block_i8_f32(I8_ARGS) {
  return launch<float, true>(x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u,
                             bias_v, pp, mask, k_q, k_s, v_q, v_s, out, k_new,
                             v_new, qkv, ctx, B, H, s_buf, d_head, eps, scale,
                             stream);
}

extern "C" int t1_attention_block_i8_bf16(I8_ARGS) {
  return launch<__nv_bfloat16, true>(
      x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u, bias_v, pp, mask, k_q,
      k_s, v_q, v_s, out, k_new, v_new, qkv, ctx, B, H, s_buf, d_head, eps,
      scale, stream);
}
