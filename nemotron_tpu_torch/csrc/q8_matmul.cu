// B4: weight-only Q8_0 linear for Hopper, sm_90a.
//
// Replaces: nemotron_tpu/ops/quant.py, _q8_matmul_kernel via
// _q8_matmul_pallas (pallas_call at :126; wrapper linear_q8_pallas :144).
// Same function, not the same grid: y = x . (w_i8 * per-32-input scale)^T,
// w_i8 [N, K] int8, scales [N, K/32] f32. The Pallas kernel dequantizes a
// whole [TN, K] weight strip in VMEM for a 256-row x tile (rows padded to
// 256); here an output tile walks K in steps of whole 32-wide blocks, one
// scale per (row, quantization block), and ragged M and N are masked
// instead of padded. The design and what bounds it are in wq_matmul.cuh.

#include "wq_matmul.cuh"

namespace {

struct Q8Codes {
  // row n holds K int8 codes, column k at byte k
  __device__ __forceinline__ static void load8(const uint8_t* w, int n, int K,
                                               int k0, float* c) {
    const uint2 v = *reinterpret_cast<const uint2*>(w + (long)n * K + k0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = (float)(int8_t)(v.x >> (8 * j));
      c[4 + j] = (float)(int8_t)(v.y >> (8 * j));
    }
  }
};

}  // namespace

// x, w_i8, scales, y, M, N, K, stream
extern "C" int q8_matmul_f32(const void* x, const void* w, const void* scales,
                             void* y, int M, int N, int K, void* stream) {
  return wq::launch_f32<Q8Codes>(x, w, scales, y, M, N, K, stream);
}

extern "C" int q8_matmul_bf16(const void* x, const void* w,
                              const void* scales, void* y, int M, int N, int K,
                              void* stream) {
  return wq::launch_bf16<Q8Codes>(x, w, scales, y, M, N, K, stream);
}
