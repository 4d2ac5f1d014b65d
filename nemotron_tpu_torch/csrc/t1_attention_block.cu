// B3: the fused T=1 attention block of one conformer layer for Hopper,
// sm_90a: LN -> Q/K/V projections -> relative-position, new-frame and
// content scores -> softmax -> context -> out projection + residual.
//
// Replaces: nemotron_tpu/ops/attn_block_pallas.py, _block_kernel via
// t1_attention_block (pallas_call at :177). Same function and the same
// rounding points, not the same grid. With E = H * Dh (D, or a tp shard's
// heads: parallel/mesh.py), for each stream b:
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
// Wq, Wk, Wv are [E, D] and Wo [D, E]; with `residual` 0 the x[b] term is
// left out, so a tp shard's out is its partial product, which the caller
// sums over the shards before it adds the residual once.
// pp [H, Dh, S_buf + 1] f32 is the phase-shifted position projection, built
// outside the kernel as in the JAX package; mask [B, S_buf + 1] holds 0 on
// live slots and -1e9 on dead ones. The caches are dense (x's type) or int8
// QuantKV codes with one f32 scale per frame, read as they are (the JAX
// package dequantizes first; the values agree up to rounding order).
//
// What bounds it on the H100: the projections read the four [D, D]
// weights (16 MB in f32, 8 MB in bf16 at D = 1024) and do 8*B*D^2 flops;
// the attention reads the caches once (as B1). At B = 256 the f32 GEMMs are
// bound by the CUDA cores' FFMA (67 TFLOP/s: 2.15 GFLOP, 32 us; full f32,
// no TF32 and no tensor-core emulation, by contract); in bf16 the bytes
// bind.
//
// Design: one entry call, three launches on the caller's stream (f32:
// four, the LN statistics first), intermediates in scratch buffers the
// wrapper allocates:
//   (a) QKV. bf16: gemm_dense_sm90<kLn> (wq_gemm_sm90.cuh): the weights
//       through a TMA ring straight into wgmma, the block's LN(x) rows
//       normalised once into a resident operand; with split-K (the plan's,
//       ops/attn_block.py:block_gemm_plans) each split writes its f32 sums
//       to its own slice of the qkv scratch [splits, B, 3D]. f32: ln_stats
//       takes each row's mean and 1/sqrt(var + eps) once, then the FFMA
//       body of wq_matmul.cuh (128- or 64-row by 128-column tiles, 8 x 8 or
//       4 x 8 outputs per thread, a register-staged two-stage ring, LN
//       applied as the x rows enter the ring) with the split-K of
//       ops/attn_block.py:block_f32_plans, each split into its own slice
//       as in bf16.
//   (b) attention: a block takes one head and a group of streams
//       (per_block, from the plan). It copies pp[h] (40 KB f32) into shared
//       memory once with a bulk copy, so pp is read once per head group,
//       not once per (stream, head). 2-4 groups of 128 threads (the plan's)
//       share it and take alternate streams, each walking its own ring of 1 or 2
//       stages: a stage holds the stream's K and V rows, its q, k, v sums
//       of every split and (int8) its scales, all by bulk copies or
//       cp.async issued a stream ahead. Per stream: q, k, v as the splits'
//       sum in split order, q + bias_u, q + bias_v, k_new / v_new out, the
//       position contraction over Dh from shared memory (a warp per
//       quarter of Dh, the four partial rows summed in order), then B1's
//       body (t1_attention.cuh); ctx to scratch in x's type. Several
//       groups, not one, so that one's math overlaps the others' waits.
//   (c) out. bf16: gemm_dense_sm90<!kLn> over ctx, the residual added in
//       the epilogue, one split; f32: the FFMA body with the plan's
//       split-K, the partials summed in split order by each tile's last
//       block (a workspace and self-resetting tile counters from the
//       wrapper), which adds the residual.
// No library GEMM runs inside: all four projections are computed here.

#include "t1_attention.cuh"
#include "wq_gemm_sm90.cuh"
#include "smem_limit.cuh"
#include "wq_matmul.cuh"

namespace {

using t1::kThreads;
using t1::kWarps;

__host__ __device__ inline int r16(int x) { return (x + 15) / 16 * 16; }

constexpr int kMaxGroups = 4;  // thread groups of kThreads per block, at most

// shared memory of one attention block, in bytes from the base: pp[h],
// bias_u and bias_v, pp's barrier; then per group `stages` stages of [K
// tile, V tile, the stream's q, k, v sums of every split, int8: ks, vs],
// q_s, qv_s, kn_s, vn_s, pm_s, w_s, the position and context partials,
// the group's softmax partials, the stages' barriers (ops/attn_block.py:
// attn_smem computes the same)
struct Layout {
  int tile, qkv, ks, vs, stage, vecs, pm, w, pos, part, red, bars, group,
      shared, total;
  __host__ __device__ Layout(int s_buf, int d_head, int elem, int stages,
                             int splits, int groups) {
    const int s1 = r16((s_buf + 1) * 4);
    tile = t1::tile_bytes(s_buf, d_head, elem);
    qkv = 2 * tile;
    ks = qkv + 3 * splits * r16(d_head * 4);
    vs = ks + (elem == 1 ? r16(s_buf * 4) : 0);
    stage = vs + (elem == 1 ? r16(s_buf * 4) : 0);
    vecs = stages * stage;  // offsets below are within a group's region
    pm = vecs + 4 * r16(d_head * 4);
    w = pm + s1;
    pos = w + s1;
    part = pos + kWarps * s1;
    red = part + 8192 / elem;
    bars = red + r16(kWarps * 4);
    group = bars + 16 * stages;
    shared = (d_head * (s_buf + 1) * 4 + 127) / 128 * 128 +
             2 * r16(d_head * 4) + 16;
    total = shared + groups * group;
  }
};

template <typename T, typename TC, int kDh>
__global__ void __launch_bounds__(kMaxGroups * kThreads)
block_attention_kernel(const float* __restrict__ qkv, int splits,
                       const T* __restrict__ bias_u,
                       const T* __restrict__ bias_v, const float* pp,
                       const T* __restrict__ mask, const TC* kc,
                       const float* __restrict__ ks, const TC* vc,
                       const float* __restrict__ vs, T* __restrict__ ctx,
                       T* __restrict__ k_new, T* __restrict__ v_new, int B,
                       int H, int s_buf, float scale, int per_block,
                       int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr bool kI8 = sizeof(TC) == 1;
  const int groups = blockDim.x / kThreads;
  const Layout lay(s_buf, kDh, (int)sizeof(TC), stages, splits, groups);
  const int pp_b = (kDh * (s_buf + 1) * 4 + 127) / 128 * 128;
  const float* pp_s = reinterpret_cast<const float*>(smem);  // [Dh][S_buf+1]
  float* bu_s = reinterpret_cast<float*>(smem + pp_b);
  float* bv_s = bu_s + kDh;
  uint64_t* pp_bar = reinterpret_cast<uint64_t*>(bv_s + kDh);

  const int g = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int lane = tid & 31, warp = tid >> 5, bar = 1 + g;
  uint8_t* gs = smem + lay.shared + g * lay.group;  // this group's region
  float* q_s = reinterpret_cast<float*>(gs + lay.vecs);  // q + bias_u
  float* qv_s = q_s + kDh;                                // q + bias_v
  float* kn_s = qv_s + kDh;
  float* vn_s = kn_s + kDh;
  float* pm_s = reinterpret_cast<float*>(gs + lay.pm);  // pos*scale + mask
  float* pos = reinterpret_cast<float*>(gs + lay.pos);  // [kWarps][S1p]
  uint64_t* bars = reinterpret_cast<uint64_t*>(gs + lay.bars);

  const int h = blockIdx.y, b0 = blockIdx.x * per_block;
  // group g takes the block's streams g, g + groups, ...
  const int count = (min(per_block, B - b0) - g + groups - 1) / groups;
  const int D = H * kDh, S1 = s_buf + 1, S1p = r16(S1 * 4) / 4;
  const long row_b = (long)kDh * sizeof(TC);
  if (threadIdx.x == 0) {
    for (int i = 0; i < groups; ++i) {
      uint64_t* gb = reinterpret_cast<uint64_t*>(smem + lay.shared +
                                                 i * lay.group + lay.bars);
      for (int st = 0; st < stages; ++st) {
        hopper::bar_init(&gb[2 * st], 1 + 32);  // bulk copies + cp.async
        hopper::bar_init(&gb[2 * st + 1], 1);
      }
    }
    hopper::bar_init(pp_bar, 1);
    hopper::bar_init_fence();
  }
  if (threadIdx.x < kDh) {
    bu_s[threadIdx.x] = t1::to_f32(bias_u[h * kDh + threadIdx.x]);
    bv_s[threadIdx.x] = t1::to_f32(bias_v[h * kDh + threadIdx.x]);
  }
  __syncthreads();

  // the group's warp 0: its stream p into stage p % stages. K's barrier: the
  // K rows and the splits' q, k, v slices of the head by bulk copies, int8
  // scales by 4-byte cp.async (their rows are not 16-byte aligned); V's
  // barrier: the V rows
  auto issue = [&](int p) {
    const long b = b0 + g + groups * p, bh = b * H + h;
    uint8_t* sb = gs + (p % stages) * lay.stage;
    uint64_t* bk = &bars[2 * (p % stages)];
    const uint32_t bytes = (uint32_t)(s_buf * row_b);
    const long off = bh * s_buf * row_b;
    if (lane == 0) {
      hopper::bar_expect(bk, bytes + 3 * splits * kDh * 4);
      hopper::bar_expect(bk + 1, bytes);
      hopper::bulk_copy(sb, reinterpret_cast<const uint8_t*>(kc) + off, bytes,
                        bk);
      hopper::bulk_copy(sb + lay.tile, reinterpret_cast<const uint8_t*>(vc) + off,
                        bytes, bk + 1);
    }
    __syncwarp();
    for (int l = lane; l < 3 * splits; l += 32)  // split l / 3, q / k / v
      hopper::bulk_copy(
          sb + lay.qkv + l * kDh * 4,
          qkv + ((long)(l / 3) * B + b) * 3 * D + (l % 3) * D + h * kDh,
          kDh * 4, bk);
    if (kI8)
      for (int i = lane; i < s_buf; i += 32) {
        hopper::cp_async4(reinterpret_cast<float*>(sb + lay.ks) + i,
                          ks + bh * s_buf + i, true);
        hopper::cp_async4(reinterpret_cast<float*>(sb + lay.vs) + i,
                          vs + bh * s_buf + i, true);
      }
    hopper::cp_async_arrive(bk);
  };
  if (tid < 32) {
    if (threadIdx.x == 0) {
      const uint32_t pp_bytes = (uint32_t)(kDh * S1 * 4);
      hopper::bar_expect(pp_bar, pp_bytes);
      hopper::bulk_copy(smem, pp + (long)h * kDh * S1, pp_bytes, pp_bar);
    }
    for (int p = 0; p < min(count, stages); ++p) issue(p);
  }

  constexpr int kDq = kDh / kWarps;  // Dh per warp in the position term
  for (int p = 0; p < count; ++p) {
    const long b = b0 + g + groups * p, bh = b * H + h;
    const uint8_t* sb = gs + (p % stages) * lay.stage;
    uint64_t* bk = &bars[2 * (p % stages)];
    const uint32_t parity = (uint32_t)((p / stages) & 1);
    const float* qkv_s = reinterpret_cast<const float*>(sb + lay.qkv);
    // this thread's mask terms, loaded while the stage lands
    float mk[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mk[i] = tid + i * kThreads < S1
                  ? t1::to_f32(mask[b * S1 + tid + i * kThreads]) : 0.f;
    hopper::bar_wait(bk, parity);
    if (tid < kDh) {
      // q, k, v: the splits' f32 sums, added in split order
      float qd = qkv_s[tid], kd = qkv_s[kDh + tid], vd = qkv_s[2 * kDh + tid];
      for (int z = 1; z < splits; ++z) {
        qd += qkv_s[3 * z * kDh + tid];
        kd += qkv_s[(3 * z + 1) * kDh + tid];
        vd += qkv_s[(3 * z + 2) * kDh + tid];
      }
      q_s[tid] = qd + bu_s[tid];
      qv_s[tid] = qd + bv_s[tid];
      kn_s[tid] = kd;
      vn_s[tid] = vd;
      k_new[bh * kDh + tid] = t1::from_f32<T>(kd);
      v_new[bh * kDh + tid] = t1::from_f32<T>(vd);
    }
    t1::group_sync(bar);
    if (p == 0) hopper::bar_wait(pp_bar, 0);

    // position term: warp w sums d in [w * kDq, (w + 1) * kDq) for 3 slots
    // per lane at a time (coalesced rows of pp_s)
    for (int s0 = lane; s0 < S1; s0 += 96) {
      float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d = warp * kDq; d < (warp + 1) * kDq; ++d) {
        const float qd = qv_s[d];
        const float* row = pp_s + d * S1;
#pragma unroll
        for (int u = 0; u < 3; ++u)
          if (s0 + 32 * u < S1) acc[u] = fmaf(qd, row[s0 + 32 * u], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < 3; ++u)
        if (s0 + 32 * u < S1) pos[warp * S1p + s0 + 32 * u] = acc[u];
    }
    t1::group_sync(bar);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = tid + i * kThreads;
      if (s < S1) {
        float v = pos[s];
        for (int w = 1; w < kWarps; ++w) v += pos[w * S1p + s];
        pm_s[s] = v * scale + mk[i];
      }
    }
    t1::group_sync(bar);

    const t1::Partial r = t1::attend<TC, kDh>(
        tid, bar, q_s, kn_s, vn_s, pm_s, sb, sb + lay.tile,
        kI8 ? reinterpret_cast<const float*>(sb + lay.ks) : nullptr,
        kI8 ? reinterpret_cast<const float*>(sb + lay.vs) : nullptr, s_buf,
        true, scale, bk, bk + 1, parity,
        reinterpret_cast<float*>(gs + lay.w),
        reinterpret_cast<float*>(gs + lay.red),
        reinterpret_cast<float*>(gs + lay.part));
    if (tid < kDh) ctx[bh * kDh + tid] = t1::from_f32<T>(r.o * (1.f / r.l));
    t1::group_sync(bar);  // the stage and the group's arrays are free again
    if (tid < 32 && p + stages < count) {
      hopper::fence_proxy_async();
      issue(p + stages);
    }
  }
}

template <typename T, typename TC>
int attention(const float* qkv, int splits, const void* bias_u,
              const void* bias_v, const void* pp, const void* mask,
              const void* kc, const void* ks, const void* vc, const void* vs,
              void* ctx, void* k_new, void* v_new, int B, int H, int s_buf,
              int d_head, float scale, int per_block, int groups,
              int stages, cudaStream_t stream) {
  if (per_block < 1 || stages < 1 || stages > 2 || groups < 1 ||
      groups > kMaxGroups || s_buf + 1 > 2 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(s_buf, d_head, (int)sizeof(TC), stages, splits, groups);
  return t1::with_d_head(d_head, [&](auto dh) {
    auto kernel = block_attention_kernel<T, TC, decltype(dh)::value>;
    static dyn_smem::Limit limit;  // per device (smem_limit.cuh)
    if (const cudaError_t e =
            dyn_smem::allow(kernel, lay.total, limit, 48 * 1024))
      return static_cast<int>(e);
    const dim3 grid((B + per_block - 1) / per_block, H);
    kernel<<<grid, groups * kThreads, lay.total, stream>>>(
        qkv, splits, static_cast<const T*>(bias_u),
        static_cast<const T*>(bias_v), static_cast<const float*>(pp),
        static_cast<const T*>(mask), static_cast<const TC*>(kc),
        static_cast<const float*>(ks), static_cast<const TC*>(vc),
        static_cast<const float*>(vs), static_cast<T*>(ctx),
        static_cast<T*>(k_new), static_cast<T*>(v_new), B, H, s_buf, scale,
        per_block, stages);
    return static_cast<int>(cudaGetLastError());
  });
}

// the plan of ops/attn_block.py:block_gemm_plans (bf16) or block_f32_plans
// (f32: batch tiles, splits, steps per split of both projections) and
// attn_group
struct Plan {
  int qkv_nt, qkv_splits, qkv_steps_per, out_nt, out_splits, out_steps_per,
      attn_per_block, attn_groups, attn_stages;
};

template <typename T, typename TC>
int launch(const void* x_, const void* ln_w, const void* ln_b,
           const void* q_w, const void* k_w, const void* v_w,
           const void* out_w, const void* bias_u, const void* bias_v,
           const void* pp, const void* mask, const void* kc, const void* k_s,
           const void* vc, const void* v_s, void* out, void* k_new,
           void* v_new, void* qkv, void* ctx, void* stats, void* ws,
           void* counters, int B, int H, int s_buf, int d_head, int D,
           int residual, float eps, float scale, const Plan& plan,
           void* stream) {
  if (B <= 0) return 0;
  const int E = H * d_head;  // the heads' width: D, or a tp shard's
  auto* st = static_cast<cudaStream_t>(stream);
  int err;
  if constexpr (sizeof(T) == 4) {  // f32: LN statistics, the FFMA body
    const float* x = static_cast<const float*>(x_);
    auto* st2 = static_cast<float2*>(stats);
    err = wq::run_ln_stats(x, st2, B, D, eps, st);
    if (err) return err;
    const wq::DenseW w_qkv{{static_cast<const float*>(q_w),
                            static_cast<const float*>(k_w),
                            static_cast<const float*>(v_w)}, E, D};
    err = wq::run_f32(wq::LnA{x, static_cast<const float*>(ln_w),
                              static_cast<const float*>(ln_b), st2, D},
                      w_qkv,
                      wq::StoreSplits{static_cast<float*>(qkv), B, 3 * E},
                      wq::F32Plan{plan.qkv_nt, plan.qkv_splits,
                                  plan.qkv_steps_per, nullptr, nullptr},
                      B, 3 * E, D, stream);
  } else {
    const void* w[3] = {q_w, k_w, v_w};
    err = wq::launch_dense<true>(x_, ln_w, ln_b, eps, w, 3, qkv, nullptr,
                                 nullptr, B, E, D, plan.qkv_nt,
                                 plan.qkv_splits, plan.qkv_steps_per, stream);
  }
  if (err) return err;

  err = attention<T, TC>(static_cast<const float*>(qkv), plan.qkv_splits,
                         bias_u, bias_v, pp, mask, kc, k_s, vc, v_s, ctx,
                         k_new, v_new, B, H, s_buf, d_head, scale,
                         plan.attn_per_block, plan.attn_groups,
                         plan.attn_stages, st);
  if (err) return err;

  if constexpr (sizeof(T) == 4) {
    const float* wo = static_cast<const float*>(out_w);
    const wq::PlainA a{static_cast<const float*>(ctx), E};
    const wq::DenseW w{{wo, wo, wo}, D, E};
    const wq::F32Plan p{plan.out_nt, plan.out_splits, plan.out_steps_per,
                        static_cast<float*>(ws), static_cast<int*>(counters)};
    if (residual)
      return wq::run_f32(a, w,
                         wq::AddResidual{static_cast<float*>(out),
                                         static_cast<const float*>(x_), D},
                         p, B, D, E, stream);
    return wq::run_f32(a, w, wq::StoreY{static_cast<float*>(out), D}, p, B, D,
                       E, stream);
  } else {
    const void* wo[1] = {out_w};
    return wq::launch_dense<false>(ctx, nullptr, nullptr, 0.f, wo, 1, nullptr,
                                   out, residual ? x_ : nullptr, B, D, E,
                                   plan.out_nt, 1,
                                   (E + wq::sm90::kStep - 1) / wq::sm90::kStep,
                                   stream);
  }
}

}  // namespace

// x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u, bias_v, pp, mask, k_buf,
// v_buf, out, k_new, v_new, qkv scratch [splits, B, 3D] f32, ctx scratch
// [B, E]; f32 only (else null): LN statistics [B, 2] f32, the out
// projection's split-K workspace and tile counters; B, H, S_buf, Dh,
// d_model D, whether to add the residual, eps, scale, the plan (QKV batch tile, splits, steps per split; out batch
// tile, splits, steps per split; streams per attention block, its thread
// groups and their rings' stages), stream
#define DENSE_ARGS                                                           \
  const void *x, const void *ln_w, const void *ln_b, const void *q_w,        \
      const void *k_w, const void *v_w, const void *out_w,                   \
      const void *bias_u, const void *bias_v, const void *pp,                \
      const void *mask, const void *k_buf, const void *v_buf, void *out,     \
      void *k_new, void *v_new, void *qkv, void *ctx, void *stats,           \
      void *ws, void *counters, int B, int H, int s_buf, int d_head,         \
      int d_model, int residual, float eps, float scale, int qkv_nt,         \
      int qkv_splits, int qkv_steps_per, int out_nt, int out_splits,         \
      int out_steps_per, int attn_per_block, int attn_groups,                \
      int attn_stages, void *stream
// the same with the int8 caches as codes and scales: k_q, k_s, v_q, v_s
#define I8_ARGS                                                              \
  const void *x, const void *ln_w, const void *ln_b, const void *q_w,        \
      const void *k_w, const void *v_w, const void *out_w,                   \
      const void *bias_u, const void *bias_v, const void *pp,                \
      const void *mask, const void *k_q, const void *k_s, const void *v_q,   \
      const void *v_s, void *out, void *k_new, void *v_new, void *qkv,       \
      void *ctx, void *stats, void *ws, void *counters, int B, int H,        \
      int s_buf, int d_head, int d_model, int residual, float eps,           \
      float scale, int qkv_nt, int qkv_splits, int qkv_steps_per,            \
      int out_nt, int out_splits,                                            \
      int out_steps_per, int attn_per_block, int attn_groups,                \
      int attn_stages, void *stream
#define PLAN                                                         \
  Plan{qkv_nt, qkv_splits, qkv_steps_per, out_nt, out_splits,       \
       out_steps_per, attn_per_block, attn_groups, attn_stages}

extern "C" int t1_attention_block_f32(DENSE_ARGS) {
  return launch<float, float>(x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u,
                              bias_v, pp, mask, k_buf, nullptr, v_buf,
                              nullptr, out, k_new, v_new, qkv, ctx, stats, ws,
                              counters, B, H, s_buf, d_head, d_model,
                              residual, eps, scale, PLAN, stream);
}

extern "C" int t1_attention_block_bf16(DENSE_ARGS) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u, bias_v, pp, mask, k_buf,
      nullptr, v_buf, nullptr, out, k_new, v_new, qkv, ctx, stats, ws,
      counters, B, H, s_buf, d_head, d_model, residual, eps, scale, PLAN,
      stream);
}

extern "C" int t1_attention_block_i8_f32(I8_ARGS) {
  return launch<float, int8_t>(x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u,
                               bias_v, pp, mask, k_q, k_s, v_q, v_s, out,
                               k_new, v_new, qkv, ctx, stats, ws, counters, B,
                               H, s_buf, d_head, d_model, residual, eps,
                               scale, PLAN, stream);
}

extern "C" int t1_attention_block_i8_bf16(I8_ARGS) {
  return launch<__nv_bfloat16, int8_t>(
      x, ln_w, ln_b, q_w, k_w, v_w, out_w, bias_u, bias_v, pp, mask, k_q,
      k_s, v_q, v_s, out, k_new, v_new, qkv, ctx, stats, ws, counters, B, H,
      s_buf, d_head, d_model, residual, eps, scale, PLAN, stream);
}
