// B5: weight-only Q4_0 linear for Hopper, sm_90a.
//
// Replaces: nemotron_tpu/ops/quant.py, _q4_matmul_kernel via
// _q4_matmul_pallas (pallas_call at :280; wrapper linear_q4_pallas :298).
// Same function: y = x . W^T with W[n, k] = (nibble(n, k) - 8) *
// scales[n, k / 32], in the JAX package's half-split packing: w_packed
// [N, K/2] uint8, original column k < K/2 in the low nibble of packed
// column k, column k >= K/2 in the high nibble of packed column k - K/2.
// With K % 64 == 0 a 32-wide quantization block never straddles the
// halves: its codes are one nibble of 32 packed bytes of one row. The
// weight bytes read per call halve against B4; the design and what bounds
// it are in wq_matmul.cuh.

#include "wq_matmul.cuh"

namespace {

struct Q4Codes {
  __device__ __forceinline__ static void load8(const uint8_t* w, int n, int K,
                                               int k0, float* c) {
    const int half = K / 2;
    int col = k0;                // original column of c[0]
    int shift = 0;               // low nibble
    if (col >= half) {
      col -= half;
      shift = 4;                 // high nibble
    }
    const uint2 v = *reinterpret_cast<const uint2*>(w + (long)n * half + col);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = (float)((int)((v.x >> (8 * j + shift)) & 0xFu) - 8);
      c[4 + j] = (float)((int)((v.y >> (8 * j + shift)) & 0xFu) - 8);
    }
  }
};

}  // namespace

// x, w_packed, scales, y, M, N, K (unpacked), stream
extern "C" int q4_matmul_f32(const void* x, const void* w, const void* scales,
                             void* y, int M, int N, int K, void* stream) {
  return wq::launch_f32<Q4Codes>(x, w, scales, y, M, N, K, stream);
}

extern "C" int q4_matmul_bf16(const void* x, const void* w,
                              const void* scales, void* y, int M, int N, int K,
                              void* stream) {
  return wq::launch_bf16<Q4Codes>(x, w, scales, y, M, N, K, stream);
}
