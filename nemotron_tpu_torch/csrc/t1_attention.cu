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
// the scale plus the additive window/validity mask. Element type: float or
// __nv_bfloat16 (q, k_new, v_new, dense caches, output); all sums are f32.
// int8 caches (t1_attention_i8_*): codes [B*H, S_buf, Dh] int8 with one f32
// scale per frame [B*H, S_buf], read as they are.
//
// What bounds it on the H100: device-memory bandwidth. Each (stream, head)
// reads its K and V rows once (2 * S_buf * Dh elements; 40 KB in bf16 at
// S_buf 78, Dh 128; 2 * S_buf * (Dh + 4) bytes with int8 caches) and does
// 2 FMAs per element; at T=1 there is no reuse, so the floor is those bytes
// over 3.35 TB/s.
//
// Design (t1_attention.cuh holds the body): one block of 128 threads per
// (stream, head). Its first warp stages everything the pair reads in
// shared memory at once, before any math: the K rows and the V rows by one
// bulk copy each (on two mbarriers, so scoring starts while V lands), q,
// k_new and v_new by bulk copies, the position terms and int8 scales by
// 4-byte cp.async. The pair's math then reads shared memory only. A block
// holds 40 KB in bf16 (80 KB in f32), so 2-5 blocks share an SM and one
// block's copies overlap another's math; a two-deep ring of pairs per
// block (fewer, longer-lived blocks) measured slower at every batch
// (PERF.md). Where there are fewer pairs than SMs (the server's batch 8
// has 64), a thread-block cluster of 2 or 4 blocks splits one pair's
// slots (ops/attn_kernel.py:attn_plan): each block copies and scores its
// share, and the cluster's first block combines the partial (max, sum,
// context) through distributed shared memory in rank order (one launch,
// no atomics; the combination is softmax's own rescaling, exp(m_r - M),
// so a share that is all dead slots weighs exactly 0).

#include "t1_attention.cuh"
#include "smem_limit.cuh"

namespace {

using t1::kProbe;
using t1::kThreads;
using t1::kWarps;

__host__ __device__ inline int r16(int x) { return (x + 15) / 16 * 16; }

// shared memory of one block, in bytes from the (aligned) base: the K
// tile, the V tile, q, k_new, v_new, pm (n + 1), int8: ks, vs (n each);
// w_s, part, the cluster's combination area, the two barriers
// (ops/attn_kernel.py:b1_smem computes the same total)
struct Layout {
  int tile, vec, q, kn, vn, pm, ks, vs, w, part, comb, bars, total;
  __host__ __device__ Layout(int n, int d_head, int elem, int act) {
    tile = t1::tile_bytes(n, d_head, elem);
    vec = r16(d_head * act);
    q = 2 * tile;
    kn = q + vec;
    vn = kn + vec;
    pm = vn + vec;
    ks = pm + r16((n + 1) * 4);
    vs = ks + (elem == 1 ? r16(n * 4) : 0);
    w = vs + (elem == 1 ? r16(n * 4) : 0);
    part = w + r16((n + 1) * 4);
    comb = part + 8192 / elem;  // 128 * kN f32
    bars = comb + r16((2 + d_head) * 4);
    total = bars + 16;
  }
};

template <typename T, typename TC, int kDh>
__global__ void __launch_bounds__(kThreads)
t1_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                    const T* __restrict__ v_new,
                    const float* __restrict__ pos_mask, const TC* kc,
                    const float* __restrict__ ks, const TC* vc,
                    const float* __restrict__ vs, T* __restrict__ out,
                    int s_buf, float scale, int cluster) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float red[kWarps];
  constexpr bool kI8 = sizeof(TC) == 1;
  const int n_max = (s_buf + cluster - 1) / cluster;
  const Layout lay(n_max, kDh, (int)sizeof(TC), (int)sizeof(T));
  float* pm_s = reinterpret_cast<float*>(smem + lay.pm);
  float* ks_s = reinterpret_cast<float*>(smem + lay.ks);
  float* vs_s = reinterpret_cast<float*>(smem + lay.vs);
  float* comb = reinterpret_cast<float*>(smem + lay.comb);
  uint64_t* bk = reinterpret_cast<uint64_t*>(smem + lay.bars);  // K, V

  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = cluster > 1 ? (int)hopper::cluster_rank() : 0;
  const int lo = rank * n_max, n = min(s_buf, lo + n_max) - lo;
  const long bh = blockIdx.x / cluster;  // stream * H + head
  if (tid == 0) {
    hopper::bar_init(bk, 1 + 32);  // bulk copies + the warp's cp.async
    hopper::bar_init(bk + 1, 1);
    hopper::bar_init_fence();
  }
  __syncthreads();

  // warp 0 stages the pair. K's barrier: the K rows, q, k_new and v_new by
  // bulk copies, the position terms and int8 scales by 4-byte cp.async
  // (their rows are not 16-byte aligned); V's barrier: the V rows.
  if (tid < 32 && !(kProbe & 2)) {
    const long row_b = (long)kDh * sizeof(TC);
    const uint32_t bytes = (uint32_t)(n * row_b);
    const uint32_t vec = (uint32_t)(kDh * sizeof(T));
    const long off = (bh * s_buf + lo) * row_b;
    if (lane == 0) {
      hopper::bar_expect(bk, bytes + 3 * vec);
      hopper::bar_expect(bk + 1, bytes);
      hopper::bulk_copy(smem, reinterpret_cast<const uint8_t*>(kc) + off,
                        bytes, bk);
      hopper::bulk_copy(smem + lay.tile,
                        reinterpret_cast<const uint8_t*>(vc) + off, bytes,
                        bk + 1);
      hopper::bulk_copy(smem + lay.q, q + bh * kDh, vec, bk);
      hopper::bulk_copy(smem + lay.kn, k_new + bh * kDh, vec, bk);
      hopper::bulk_copy(smem + lay.vn, v_new + bh * kDh, vec, bk);
    }
    const float* pmg = pos_mask + bh * (s_buf + 1);
    for (int i = lane; i <= n; i += 32)
      hopper::cp_async4(pm_s + i, i < n ? pmg + lo + i : pmg + s_buf, true);
    if (kI8)
      for (int i = lane; i < n; i += 32) {
        hopper::cp_async4(ks_s + i, ks + bh * s_buf + lo + i, true);
        hopper::cp_async4(vs_s + i, vs + bh * s_buf + lo + i, true);
      }
    hopper::cp_async_arrive(bk);
  }

  const t1::Partial r = t1::attend<TC, kDh>(
      tid, 0, reinterpret_cast<const T*>(smem + lay.q),
      reinterpret_cast<const T*>(smem + lay.kn),
      reinterpret_cast<const T*>(smem + lay.vn), pm_s, smem, smem + lay.tile,
      kI8 ? ks_s : nullptr, kI8 ? vs_s : nullptr, n, rank == 0, scale, bk,
      bk + 1, 0u, reinterpret_cast<float*>(smem + lay.w), red,
      reinterpret_cast<float*>(smem + lay.part));
  if (cluster == 1) {
    if (tid < kDh) out[bh * kDh + tid] = t1::from_f32<T>(r.o * (1.f / r.l));
    return;
  }
  // the partial (m, l, o) of every rank meet in rank 0, in rank order
  if (tid == 0) {
    comb[0] = r.m;
    comb[1] = r.l;
  }
  if (tid < kDh) comb[2 + tid] = r.o;
  hopper::cluster_sync();
  if (rank == 0 && tid < kDh) {
    float m = r.m;
    for (int c = 1; c < cluster; ++c) m = fmaxf(m, hopper::ld_cluster(comb, c));
    float l = 0.f, o = 0.f;
    for (int c = 0; c < cluster; ++c) {
      const float mc = c ? hopper::ld_cluster(comb, c) : r.m;
      const float lc = c ? hopper::ld_cluster(comb + 1, c) : r.l;
      const float oc = c ? hopper::ld_cluster(comb + 2 + tid, c) : r.o;
      const float f = expf(mc - m);  // a share of dead slots: exactly 0
      l = fmaf(lc, f, l);
      o = fmaf(oc, f, o);
    }
    out[bh * kDh + tid] = t1::from_f32<T>(o * (1.f / l));
  }
  hopper::cluster_sync();  // rank 0 has read every block's shared memory
}

template <typename T, typename TC>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* pos_mask, const void* kc, const void* ks,
           const void* vc, const void* vs, void* out, int pairs, int s_buf,
           int d_head, float scale, int cluster, void* stream) {
  if (pairs <= 0) return 0;
  if (cluster < 1 || cluster > 8 || s_buf < cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_max = (s_buf + cluster - 1) / cluster;
  if (n_max * (cluster - 1) >= s_buf)  // a block of the cluster with no slot
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(n_max, d_head, (int)sizeof(TC), (int)sizeof(T));
  return t1::with_d_head(d_head, [&](auto dh) {
    auto kernel = t1_attention_kernel<T, TC, decltype(dh)::value>;
    static dyn_smem::Limit limit;  // per device (smem_limit.cuh)
    if (const cudaError_t e =
            dyn_smem::allow(kernel, lay.total, limit, 48 * 1024))
      return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(pairs * cluster));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)lay.total;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<const float*>(pos_mask),
        static_cast<const TC*>(kc), static_cast<const float*>(ks),
        static_cast<const TC*>(vc), static_cast<const float*>(vs),
        static_cast<T*>(out), s_buf, scale, cluster);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// q, k_new, v_new, pos_mask, k_buf, v_buf, out, batch*heads, s_buf, d_head,
// scale, then the plan (pairs per block, cluster size), stream
extern "C" int t1_attention_f32(const void* q, const void* k_new,
                                const void* v_new, const void* pos_mask,
                                const void* k_buf, const void* v_buf,
                                void* out, int batch_heads, int s_buf,
                                int d_head, float scale, int cluster,
                                void* stream) {
  return launch<float, float>(q, k_new, v_new, pos_mask, k_buf, nullptr,
                              v_buf, nullptr, out, batch_heads, s_buf, d_head,
                              scale, cluster, stream);
}

extern "C" int t1_attention_bf16(const void* q, const void* k_new,
                                 const void* v_new, const void* pos_mask,
                                 const void* k_buf, const void* v_buf,
                                 void* out, int batch_heads, int s_buf,
                                 int d_head, float scale, int cluster,
                                 void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      q, k_new, v_new, pos_mask, k_buf, nullptr, v_buf, nullptr, out,
      batch_heads, s_buf, d_head, scale, cluster, stream);
}

// the same with the int8 caches as k codes, k scales, v codes, v scales
extern "C" int t1_attention_i8_f32(const void* q, const void* k_new,
                                   const void* v_new, const void* pos_mask,
                                   const void* k_q, const void* k_s,
                                   const void* v_q, const void* v_s,
                                   void* out, int batch_heads, int s_buf,
                                   int d_head, float scale, int cluster,
                                   void* stream) {
  return launch<float, int8_t>(q, k_new, v_new, pos_mask, k_q, k_s, v_q, v_s,
                               out, batch_heads, s_buf, d_head, scale,
                               cluster, stream);
}

extern "C" int t1_attention_i8_bf16(const void* q, const void* k_new,
                                    const void* v_new, const void* pos_mask,
                                    const void* k_q, const void* k_s,
                                    const void* v_q, const void* v_s,
                                    void* out, int batch_heads, int s_buf,
                                    int d_head, float scale, int cluster,
                                    void* stream) {
  return launch<__nv_bfloat16, int8_t>(q, k_new, v_new, pos_mask, k_q, k_s,
                                       v_q, v_s, out, batch_heads, s_buf,
                                       d_head, scale, cluster, stream);
}
