// Masked in-place rewrites of K/V cache rows for Hopper, sm_90a: the slack
// buffer's compaction, realign-on-resume and the slot reset at a join.
//
// Replaces no TPU kernel. The JAX package writes these moves as XLA ops
// over every row (nemotron_tpu/models/encoder.py compact_cache and
// realign_cache: static slices, a roll and kv_where; streaming/state.py
// reset_slots: jnp.where), jitted with the caches donated. The port ran
// them eagerly, picking rows with torch.nonzero: a device-to-host sync,
// which a CUDA graph cannot hold. This kernel reads the [B] mask on the
// device, so the four slot operations run as captured graphs.
//
// A buffer is [L, B, H, S, W bytes]: dense f32 / bf16 caches (W = Dh x
// elem), int8 codes (W = Dh), or a QuantKV's f32 scales [L, B, H, S]
// (W = 4); a HeadShards part is one buffer on its own device. A row is
// one (layer, slot, head): S frames of W bytes, contiguous. For each row
// whose slot's mask byte is set (every row when the mask is null):
//     shift (mode 0): frames [lo, lo + lc) -> [0, lc)   (the compaction)
//     roll  (mode 1): frame s -> (s + shift) mod S      (the realign)
//     zero  (mode 2): every byte 0                       (the reset)
// Pure copies: bit-exact in any element type.
//
// What bounds it on the H100: device-memory bandwidth. A masked row moves
// its bytes once each way (shift: 2 lc W, roll: 2 S W, zero: S W written);
// a clear row costs its block one mask byte. At B=256, R=0, bf16 the wrap
// moves 1.76 GB each way over K and V (~1.05 ms at 3.35 TB/s), a resumed
// slot's rows ~15 MB.
//
// Design: a block of 256 threads per (layer, slot, group of heads); a
// group is as many of the slot's heads as stage in 48 KB
// (ops/kv_rows.kv_rows_plan), so the small rows (scales, int8 codes) still
// fill a block. The block reads its slot's mask byte and returns if it is
// clear. Source and destination overlap (shift: lo = 8 < lc = 70 at R=0;
// roll: the whole row), so the block reads what it moves into shared
// memory first, kUnroll vectors a thread in flight, then writes it back
// after one barrier. Vectors are 16 bytes wherever the frame width and
// the buffer's address allow (every full-width buffer but the scales: 4
// bytes). No index list, no scratch, no host read; one launch per buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kSmemMax = 232448;  // the H100's opt-in shared memory a block

enum Mode { kShift = 0, kRoll = 1, kZero = 2 };

template <typename V>
__global__ void __launch_bounds__(kThreads)
kv_rows_kernel(V* buf, const uint8_t* __restrict__ mask, int batch,
               int heads, int group, int row_v, int frame_v, int mode,
               int lo, int lc, int shift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* stage = reinterpret_cast<V*>(smem_raw);
  const int groups = heads / group;
  const long long lb = blockIdx.x / groups;  // layer * batch + slot
  const int g = static_cast<int>(blockIdx.x - lb * groups);
  if (mask != nullptr && mask[lb % batch] == 0) return;
  V* base = buf + (lb * heads + static_cast<long long>(g) * group) * row_v;

  if (mode == kZero) {
    const V z = {};
    const int n = group * row_v;  // the group's rows are contiguous
    for (int i = threadIdx.x; i < n; i += kThreads) base[i] = z;
    return;
  }
  // shift reads frames [lo, lo + lc) of each row, roll the whole row
  const int n_row = mode == kShift ? lc * frame_v : row_v;
  const int src0 = mode == kShift ? lo * frame_v : 0;
  const int n = group * n_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
    V r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int h = i / n_row;
        r[u] = base[h * row_v + src0 + (i - h * n_row)];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) stage[i] = r[u];
    }
  }
  __syncthreads();
  const int sv = mode == kRoll ? shift * frame_v : 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int h = i / n_row;
    int j = i - h * n_row + sv;  // shift: j < lc W; roll: wraps once
    if (j >= n_row) j -= n_row;
    base[h * row_v + j] = stage[i];
  }
}

template <typename V>
int launch(void* buf, const void* mask, int lb, int batch, int heads,
           int group, int s, int w, int mode, int lo, int lc, int shift,
           cudaStream_t stream) {
  const int frame_v = w / static_cast<int>(sizeof(V));
  const int staged = mode == kZero ? 0 : group * (mode == kShift ? lc : s) * w;
  auto kernel = kv_rows_kernel<V>;
  static dyn_smem::Limit limit;  // per device (smem_limit.cuh)
  if (const cudaError_t e =
          dyn_smem::allow(kernel, staged, limit, 48 * 1024))
    return static_cast<int>(e);
  const long long blocks = static_cast<long long>(lb) * (heads / group);
  kernel<<<static_cast<unsigned>(blocks), kThreads, staged, stream>>>(
      static_cast<V*>(buf), static_cast<const uint8_t*>(mask), batch, heads,
      group, s * frame_v, frame_v, mode, lo, lc, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buf: the buffer's base; mask: [batch] bytes (bool) or null for every row;
// lb = L x batch; heads (H of this buffer), group (heads per block, divides
// heads), s frames of w bytes a row; vec: the vector width in bytes (16, 8,
// 4, 2 or 1; divides w and the base address); mode 0 shift (lo, lc), 1 roll
// (shift in [0, s)), 2 zero; stream.
extern "C" int kv_rows(void* buf, const void* mask, int lb, int batch,
                       int heads, int group, int s, int w, int vec, int mode,
                       int lo, int lc, int shift, void* stream) {
  if (lb <= 0) return 0;
  if (batch <= 0 || heads <= 0 || group <= 0 || heads % group || s <= 0 ||
      w <= 0 || vec <= 0 || w % vec ||
      reinterpret_cast<uintptr_t>(buf) % vec || mode < kShift ||
      mode > kZero ||
      (mode == kShift && (lo < 0 || lc <= 0 || lo + lc > s)) ||
      (mode == kRoll && (shift < 0 || shift >= s)) ||
      static_cast<long long>(lb) * (heads / group) > 0x7fffffffLL ||
      static_cast<long long>(group) * s * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kZero &&
      static_cast<long long>(group) * (mode == kShift ? lc : s) * w > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16:
      return launch<uint4>(buf, mask, lb, batch, heads, group, s, w, mode, lo,
                           lc, shift, st);
    case 8:
      return launch<uint2>(buf, mask, lb, batch, heads, group, s, w, mode, lo,
                           lc, shift, st);
    case 4:
      return launch<uint32_t>(buf, mask, lb, batch, heads, group, s, w, mode,
                              lo, lc, shift, st);
    case 2:
      return launch<uint16_t>(buf, mask, lb, batch, heads, group, s, w, mode,
                              lo, lc, shift, st);
    case 1:
      return launch<uint8_t>(buf, mask, lb, batch, heads, group, s, w, mode,
                             lo, lc, shift, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
