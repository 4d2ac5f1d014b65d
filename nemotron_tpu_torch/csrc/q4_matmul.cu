// B5: weight-only Q4_0 linear for Hopper, sm_90a.
//
// Replaces: nemotron_tpu/ops/quant.py, _q4_matmul_kernel via
// _q4_matmul_pallas (pallas_call at :280; wrapper linear_q4_pallas :298).
// Same function: y = x . W^T with W[n, k] = (nibble(n, k) - 8) *
// scales[n, k / 32], in the JAX package's half-split packing: w_packed
// [N, K/2] uint8, original column k < K/2 in the low nibble of packed
// column k, column k >= K/2 in the high nibble of packed column k - K/2.
// With K % 64 == 0 a 32-wide quantization block never straddles the
// halves: its codes are one nibble of 32 packed bytes of one row.
//
// What bounds it on the H100, bf16 x at the main path's shapes: at M = 256
// the flops (2*M*N*K on the bf16 tensor cores, 2.2 us for 4M weights),
// below M ~ 100 the bytes, which halve against B4 (N*K/2 packed codes +
// N*K/8 bytes of scales). The bf16 export runs wq_gemm_sm90.cuh: each
// pipeline step loads 64 packed columns and the two x tiles they pair with
// (columns j.. and K/2 + j..), so a packed byte is read once per batch
// tile of 64-128 rows; its header has the design. The calls of many rows
// take the large-M form of wq_gemm_large.cuh from gemm_plan's crossover,
// as B4's: pass 1 unpacks both nibbles of each packed byte once into the
// bf16 weight. With f32 x the flops
// bind on the CUDA cores (67 TFLOP/s, full f32 FFMA) as for B4: the f32
// export runs wq_matmul.cuh's FFMA body, B4's design with the nibble
// loader below (each code dequantized once per block).

#include "wq_gemm_large.cuh"
#include "wq_gemm_sm90.cuh"
#include "wq_matmul.cuh"

namespace {

struct Q4Codes {
  // original columns k0 .. k0+7 (8 | k0, all in one half of K): 8 packed
  // bytes of row n, the low nibbles for k0 < K/2, the high ones above
  using Raw = uint2;
  __device__ __forceinline__ static Raw fetch(const uint8_t* w, int n, int K,
                                              int k0) {
    const int half = K / 2;
    const int col = k0 >= half ? k0 - half : k0;
    return __ldg(reinterpret_cast<const uint2*>(w + (long)n * half + col));
  }
  __device__ __forceinline__ static void unpack(Raw v, int K, int k0,
                                                float* c) {
    const int shift = k0 >= K / 2 ? 4 : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = (float)((int)((v.x >> (8 * j + shift)) & 0xFu) - 8);
      c[4 + j] = (float)((int)((v.y >> (8 * j + shift)) & 0xFu) - 8);
    }
  }
};

}  // namespace

// x, w_packed, scales, y, split-K workspace, tile counters, M, N, K
// (unpacked), then the plan (ops/quant.py:f32_plan): batch tile, splits,
// steps per split; stream
extern "C" int q4_matmul_f32(const void* x, const void* w, const void* scales,
                             void* y, void* ws, void* counters, int M, int N,
                             int K, int bm, int splits, int steps_per,
                             void* stream) {
  return wq::launch_f32<Q4Codes>(x, w, scales, y, ws, counters, M, N, K, bm,
                                 splits, steps_per, stream);
}

// x, w_packed, scales, y, workspace, M, N, K (unpacked), then the plan
// (ops/quant.py:gemm_plan): m_tile, splits, steps per split; stream
extern "C" int q4_matmul_bf16(const void* x, const void* w,
                              const void* scales, void* y, void* ws, int M,
                              int N, int K, int m_tile, int splits,
                              int steps_per, void* stream) {
  return wq::launch_sm90<true>(x, w, scales, y, ws, M, N, K, m_tile, splits,
                               steps_per, stream);
}

// x, the codes, scales, y, bf16 scratch of the dequantized weight [N, K],
// M, N, K (unpacked), then the large-M plan (ops/quant.py:gemm_plan): the
// weight-row tile and the persistent blocks; stream
extern "C" int q4_matmul_bf16_large(const void* x, const void* w,
                                    const void* scales, void* y, void* wbuf,
                                    int M, int N, int K, int bn, int blocks,
                                    void* stream) {
  return wq::launch_large<true>(x, w, scales, y, wbuf, M, N, K, bn, blocks,
                                stream);
}
