// B4: weight-only Q8_0 linear for Hopper, sm_90a.
//
// Replaces: nemotron_tpu/ops/quant.py, _q8_matmul_kernel via
// _q8_matmul_pallas (pallas_call at :126; wrapper linear_q8_pallas :144).
// Same function, not the same grid: y = x . (w_i8 * per-32-input scale)^T,
// w_i8 [N, K] int8, scales [N, K/32] f32. The Pallas kernel dequantizes a
// whole [TN, K] weight strip in VMEM for a 256-row x tile (rows padded to
// 256).
//
// What bounds it on the H100, bf16 x at the main path's shapes: at M = 256
// the flops (2*M*N*K on the bf16 tensor cores, 2.2 us for N*K = 4M
// weights), below M ~ 100 the bytes (N*K codes + N*K/8 bytes of scales, 1.4
// us for 4M weights at 3.35 TB/s). The bf16 export runs wq_gemm_sm90.cuh:
// wgmma with the streams as its N, a TMA ring, every code dequantized once
// per batch tile of 64-128 rows, split-K for narrow N; its header has the
// design. The calls of many rows (M = B x chunk_len past right context 0,
// B x T' offline: 512 to 16,384) bind on the flops (0.139 ms at 16,384 and
// (4096, 1024)), and there the swap form re-reads and re-dequantizes each
// code tile once per 128 rows: from gemm_plan's crossover they take the
// large-M form of wq_gemm_large.cuh, the weight dequantized once to bf16
// and a persistent, warp-specialised wgmma GEMM on 128 x 256 tiles. With
// f32 x the flops bind from M ~ 16 up on the CUDA cores (67 TFLOP/s, full
// f32 FFMA: 32 us for 4M weights at M = 256): the f32 export runs
// wq_matmul.cuh's FFMA body, 128 x 128 (or 64 x 128) output tiles with
// 8 x 8 (4 x 8) outputs per thread, a two-stage register-staged ring, each
// code dequantized once per block, and split-K summed in split order by the
// tile's last block (plan: ops/quant.py:f32_plan); its header has the
// design.

#include "wq_gemm_large.cuh"
#include "wq_gemm_sm90.cuh"
#include "wq_matmul.cuh"

namespace {

struct Q8Codes {
  // row n holds K int8 codes, column k at byte k; 8 codes as one uint2
  using Raw = uint2;
  __device__ __forceinline__ static Raw fetch(const uint8_t* w, int n, int K,
                                              int k0) {
    return __ldg(reinterpret_cast<const uint2*>(w + (long)n * K + k0));
  }
  __device__ __forceinline__ static void unpack(Raw v, int, int, float* c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = (float)(int8_t)(v.x >> (8 * j));
      c[4 + j] = (float)(int8_t)(v.y >> (8 * j));
    }
  }
};

}  // namespace

// x, w_i8, scales, y, split-K workspace, tile counters, M, N, K, then the
// plan (ops/quant.py:f32_plan): batch tile, splits, steps per split; stream
extern "C" int q8_matmul_f32(const void* x, const void* w, const void* scales,
                             void* y, void* ws, void* counters, int M, int N,
                             int K, int bm, int splits, int steps_per,
                             void* stream) {
  return wq::launch_f32<Q8Codes>(x, w, scales, y, ws, counters, M, N, K, bm,
                                 splits, steps_per, stream);
}

// x, w_i8, scales, y, workspace, M, N, K, then the plan (ops/quant.py:
// gemm_plan): m_tile, splits, steps per split; stream
extern "C" int q8_matmul_bf16(const void* x, const void* w,
                              const void* scales, void* y, void* ws, int M,
                              int N, int K, int m_tile, int splits,
                              int steps_per, void* stream) {
  return wq::launch_sm90<false>(x, w, scales, y, ws, M, N, K, m_tile, splits,
                                steps_per, stream);
}

// x, the codes, scales, y, bf16 scratch of the dequantized weight [N, K],
// M, N, K, then the large-M plan (ops/quant.py:gemm_plan): the
// weight-row tile and the persistent blocks; stream
extern "C" int q8_matmul_bf16_large(const void* x, const void* w,
                                    const void* scales, void* y, void* wbuf,
                                    int M, int N, int K, int bn, int blocks,
                                    void* stream) {
  return wq::launch_large<false>(x, w, scales, y, wbuf, M, N, K, bn, blocks,
                                stream);
}
