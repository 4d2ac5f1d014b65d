// Log-mel frames of pre-emphasized audio for Hopper, sm_90a.
//
// Replaces: nemotron_tpu/ops/mel_pallas.py, _mel_kernel via
// mel_frames_pallas (pallas_call at :84), the kernel behind
// make_mel_step_pallas. Same function: for stream b and frame t
//     x[n]   = buf[b, t*160 + n] * window512[n]           n < 512
//     X[k]   = sum_n x[n] e^(-2 pi i k n / 512)          k < 257
//     out[m] = log(sum_k |X[k]|^2 fb[m, k] + 2^-24)      m < n_mels
// with f32 inputs, window product, power, filterbank sum and log, and the
// FFT in float64; no TF32 anywhere. The TPU kernel runs the DFT as two
// matmuls against cos/sin tables; this one runs an FFT.
//
// Why the FFT is float64: on a loud frame (a full-scale tone with noise at
// -60 dB) the weak bins are differences of values ~1e4 times larger, and
// f32 rounding in the FFT's passes moved log-mel bands just above the
// guard by ~1e-3, as far as the DFT-matmul of the plain version (f32
// tables and sums) moves them itself. In float64 the kernel's log-mel is
// within f32 rounding of the exact one (chip_smoke.py phase 3 prints both
// distances). The FFT is ~10k operations a frame; the card's float64 rate
// is half its f32 rate.
//
// What bounds it on the H100: neither HBM nor FLOPs at serving sizes. Per
// frame the audio is 2 KB (640 B new at hop 160), a 512-point real FFT is
// ~12k operations and the filterbank product 2 x 257 x n_mels with a dense
// filterbank, ~4 x 257 with a slaney one. So the limit is latency and what
// each block re-reads: a DFT as matmuls reads 1 MB of tables per frame,
// and a frame read on its own reads its 512 samples again.
//
// Design:
// - A block is one stream x a tile of F frames (F <= 16, the plan of
//   ops/mel_kernel.mel_plan), 16 threads per frame. One thread stages the
//   tile's (F - 1) * 160 + 512 samples, the window, the twiddle table and
//   the filterbank's non-zero weights by bulk copies on two mbarriers (the
//   weights land while the FFT runs): each sample is read from HBM about
//   once, and no table is read per frame.
// - The 512-point real FFT is the 256-point complex FFT of
//   z[n] = x[2n] + i x[2n+1] (window applied as the samples are read),
//   in four steps of 16 x 16, in float64: thread j takes z[j + 16 m],
//   m < 16, runs a 16-point DFT in registers (radix 4 x 4), multiplies by
//   W256^(j k1) and writes its row to a per-frame exchange padded to 17
//   (no bank conflicts); after __syncwarp thread k1 reads column k1, runs
//   the second 16-point DFT and holds Z[k1 + 16 k2]. The split into X[k],
//   k <= 256, pairs Z[k] with Z[256 - k], which lives in lane
//   (16 - k1) % 16 of the same half-warp: one shuffle per bin.
// - Twiddles W256^(j k1) ([k1][j], conflict-free reads) and W512^k are a
//   float64 table computed on the host (ops/mel_kernel.twiddle_table).
// - The power spectrum goes to shared memory as [bin][frame] (over the
//   exchange, after a barrier); the filterbank runs one thread per (mel,
//   group of 4 frames) over the mel's non-zero band [lo, hi), its weights
//   packed mel after mel (ops/mel_kernel.filterbank_layout) and staged
//   whole: a dense filterbank's 257 x 128 floats (128 KB; one block per
//   SM then), a slaney one's ~2 KB of triangles. Skipped terms are +0 and
//   cannot change a sum. The sum runs over bins in ascending order.
//   Staged, because read from global memory inside the loop a dense
//   filterbank's dependent steps (2 x 257 a thread) wait on L2 each time.
// - log(x + 2^-24) is written coalesced across mels to [B, n_frames,
//   n_mels]. One launch per call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_async.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kNfft = 512;
constexpr int kHop = 160;
constexpr int kBins = kNfft / 2 + 1;  // 257
constexpr int kLanes = 16;            // threads per frame
constexpr int kMaxFrames = 16;        // frames per block, at most
constexpr int kXchRow = 17;           // padded row of the 16 x 16 exchange
constexpr int kXch = kLanes * kXchRow;  // double2 per frame
constexpr int kTw1 = 256;             // W256^(j k1) at [k1 * 16 + j]
constexpr int kTwiddles = kTw1 + kBins;  // + W512^k at kTw1 + k, k <= 256
constexpr int kGroup = 4;             // frames per filterbank unit
constexpr int kSmemMax = 232448 - 1024;  // opt-in shared memory, less the
                                          // static part and a margin
constexpr float kLogGuard = 5.9604644775390625e-8f;  // 2^-24

// shared memory of one block of f_t frames with n_w filterbank weights
// (byte offsets; every region 16-byte aligned for the bulk copies and the
// float4 power reads); the power rows reuse the exchange's bytes
struct Layout {
  int frames;   // frames the block computes: f_t rounded up to whole warps
  int pstride;  // floats per power row [bin][frame]: a multiple of 4 that
                // is 4 mod 8, so the FFT's power writes meet at most 2-way
  int win, tw, xch, w, total;
  __host__ __device__ Layout(int f_t, int n_w) {
    frames = (f_t + 1) / 2 * 2;
    pstride = (f_t + 7) / 8 * 8 + 4;
    win = ((frames - 1) * kHop + kNfft) * 4;
    tw = win + kNfft * 4;
    xch = tw + kTwiddles * 16;
    const int xch_bytes = frames * kXch * 16, pw_bytes = kBins * pstride * 4;
    w = xch + (xch_bytes > pw_bytes ? xch_bytes : pw_bytes);
    total = w + n_w * 4;
  }
};

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}

// v * (c - i s): a forward twiddle e^(-i theta) with c = cos, s = sin
__device__ __forceinline__ double2 rot(double2 v, double c, double s) {
  return make_double2(fma(c, v.x, s * v.y), fma(c, v.y, -s * v.x));
}

// forward 4-point DFT in place, natural order
__device__ __forceinline__ void fft4(double2& a0, double2& a1, double2& a2,
                                     double2& a3) {
  const double2 t0 = make_double2(a0.x + a2.x, a0.y + a2.y);
  const double2 t1 = make_double2(a0.x - a2.x, a0.y - a2.y);
  const double2 t2 = make_double2(a1.x + a3.x, a1.y + a3.y);
  const double2 t3 = make_double2(a1.x - a3.x, a1.y - a3.y);
  a0 = make_double2(t0.x + t2.x, t0.y + t2.y);
  a2 = make_double2(t0.x - t2.x, t0.y - t2.y);
  a1 = make_double2(t1.x + t3.y, t1.y - t3.x);  // t1 - i t3
  a3 = make_double2(t1.x - t3.y, t1.y + t3.x);  // t1 + i t3
}

// forward 16-point DFT in registers, natural order in and out: 4-point
// DFTs over m = m1 + 4 m2, twiddles W16^(m1 k2), 4-point DFTs over m1
__device__ __forceinline__ void fft16(double2 (&v)[16]) {
  constexpr double c1 = 0.92387953251128675613, s1 = 0.38268343236508977173;
  constexpr double h = 0.70710678118654752440;
#pragma unroll
  for (int m1 = 0; m1 < 4; ++m1) fft4(v[m1], v[m1 + 4], v[m1 + 8], v[m1 + 12]);
  // v[m1 + 4 k2] *= W16^(m1 k2)
  v[5] = rot(v[5], c1, s1);
  v[9] = rot(v[9], h, h);
  v[13] = rot(v[13], s1, c1);
  v[6] = rot(v[6], h, h);
  v[10] = make_double2(v[10].y, -v[10].x);  // W16^4 = -i
  v[14] = rot(v[14], -h, h);
  v[7] = rot(v[7], s1, c1);
  v[11] = rot(v[11], -h, h);
  v[15] = rot(v[15], -c1, -s1);  // W16^9
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2)
    fft4(v[4 * k2], v[4 * k2 + 1], v[4 * k2 + 2], v[4 * k2 + 3]);
  // X[k2 + 4 k1] sits at v[4 k2 + k1]
  double2 t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = v[4 * (k % 4) + k / 4];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = t[k];
}

__global__ void __launch_bounds__(kLanes * kMaxFrames)
mel_frames_kernel(const float* __restrict__ buf,
                  const float* __restrict__ window,
                  const double2* __restrict__ twiddles,
                  const float* __restrict__ weights,
                  const int4* __restrict__ bands, float* __restrict__ out,
                  int n_buf, int n_frames, int n_mels, int n_w, int f_t) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t bar[2];  // the FFT's inputs; the filterbank weights
  const Layout lay(f_t, n_w);
  const float* samples = reinterpret_cast<const float*>(smem);
  const float2* win2 = reinterpret_cast<const float2*>(smem + lay.win);
  const double2* tw = reinterpret_cast<const double2*>(smem + lay.tw);
  float* pw = reinterpret_cast<float*>(smem + lay.xch);
  const float* wsm = reinterpret_cast<const float*>(smem + lay.w);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * f_t;
  const int n_t = min(f_t, n_frames - t0);  // frames of this tile
  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::bar_init(&bar[0], 1);
    hopper::bar_init(&bar[1], 1);
    hopper::bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {  // the weights land while the FFT runs
    const uint32_t bytes = static_cast<uint32_t>((n_t - 1) * kHop + kNfft) * 4;
    hopper::bar_expect(&bar[0], bytes + kNfft * 4 + kTwiddles * 16);
    hopper::bulk_copy(smem, buf + (long)b * n_buf + (long)t0 * kHop, bytes,
                      &bar[0]);
    hopper::bulk_copy(smem + lay.win, window, kNfft * 4, &bar[0]);
    hopper::bulk_copy(smem + lay.tw, twiddles, kTwiddles * 16, &bar[0]);
    hopper::bar_expect(&bar[1], n_w * 4);
    if (n_w > 0) hopper::bulk_copy(smem + lay.w, weights, n_w * 4, &bar[1]);
  }
  hopper::bar_wait(&bar[0], 0);

  // the FFT of frame f by its 16 threads (frames past the tile compute on
  // whatever the staging area holds and store nothing)
  const int f = tid / kLanes;
  const int j = tid % kLanes;
  const float2* z = reinterpret_cast<const float2*>(samples + f * kHop);
  double2 v[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) {  // the window product in f32, as the plain
    const float2 s = z[j + 16 * m], w = win2[j + 16 * m];  // version's
    v[m] = make_double2(s.x * w.x, s.y * w.y);
  }
  fft16(v);  // v[k1] = sum_m z[j + 16 m] W16^(m k1)
  double2* x = reinterpret_cast<double2*>(smem + lay.xch) + f * kXch;
  x[j] = v[0];
#pragma unroll
  for (int k1 = 1; k1 < 16; ++k1)
    x[k1 * kXchRow + j] = cmul(v[k1], tw[k1 * 16 + j]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = x[j * kXchRow + i];
  fft16(v);  // v[k2] = Z[j + 16 k2]
  __syncthreads();  // every frame's exchange read: the power rows reuse it

  // split: X[k] = E[k] + W512^k O[k] with E, O from Z[k] and
  // conj(Z[256 - k]); Z[256 - k] is v[15 - k2] of lane 16 - j, or for
  // j = 0 this lane's v[(16 - k2) % 16]
  const int partner = (tid & 16) | ((16 - j) & 15);
  float* prow = pw + f;
#pragma unroll
  for (int k2 = 0; k2 < 16; ++k2) {
    const double2 send = j == 0 ? v[(16 - k2) & 15] : v[15 - k2];
    const double a = __shfl_sync(0xffffffffu, send.x, partner);
    const double c = __shfl_sync(0xffffffffu, send.y, partner);
    const double2 zk = v[k2];
    const double er = 0.5 * (zk.x + a), ei = 0.5 * (zk.y - c);
    const double orr = 0.5 * (zk.y + c), oi = 0.5 * (a - zk.x);
    const int k = j + 16 * k2;
    const double2 w = tw[kTw1 + k];
    const double xr = er + fma(w.x, orr, -w.y * oi);
    const double xi = ei + fma(w.x, oi, w.y * orr);
    prow[k * lay.pstride] = static_cast<float>(fma(xr, xr, xi * xi));
  }
  if (j == 0) {  // X[256] = Re Z[0] - Im Z[0]
    const double d = v[0].x - v[0].y;
    prow[(kBins - 1) * lay.pstride] = static_cast<float>(d * d);
  }
  __syncthreads();
  hopper::bar_wait(&bar[1], 0);

  // filterbank and log: one unit per (mel, group of 4 frames)
  const int units = (n_t + kGroup - 1) / kGroup * n_mels;
  float* dst = out + ((long)b * n_frames + t0) * n_mels;
  for (int u = tid; u < units; u += blockDim.x) {
    const int m = u % n_mels, g = u / n_mels;
    const int4 band = __ldg(&bands[m]);  // lo, hi, weights of bin k at z + k
    const float* wm = wsm + band.z;
    const float* p = pw + g * kGroup;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = band.x; k < band.y; ++k) {
      const float wk = wm[k];
      const float4 pk = *reinterpret_cast<const float4*>(p + k * lay.pstride);
      acc.x = fmaf(pk.x, wk, acc.x);
      acc.y = fmaf(pk.y, wk, acc.y);
      acc.z = fmaf(pk.z, wk, acc.z);
      acc.w = fmaf(pk.w, wk, acc.w);
    }
    const int f0 = g * kGroup;
    const float r[kGroup] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (f0 + i < n_t)
        dst[(long)(f0 + i) * n_mels + m] = logf(r[i] + kLogGuard);
  }
}

}  // namespace

// buf [batch, n_buf] f32 (16-byte aligned, n_buf % 4 == 0), window [512]
// (16-byte aligned), twiddles [kTwiddles] double2, weights [n_w] f32 (the
// filterbank's bands packed mel after mel; n_w % 4 == 0, 16-byte aligned),
// bands [n_mels] int4 (lo, hi, offset of bin 0's weight, 0), out [batch,
// n_frames, n_mels]; frames_per_block is the plan's tile (1..16)
extern "C" int mel_frames_f32(const void* buf, const void* window,
                              const void* twiddles, const void* weights,
                              const void* bands, void* out, int batch,
                              int n_buf, int n_frames, int n_mels, int n_w,
                              int frames_per_block, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  const Layout lay(frames_per_block, n_w);
  if (frames_per_block < 1 || frames_per_block > kMaxFrames || n_mels < 1 ||
      batch > 65535 || n_buf % 4 != 0 || n_w % 4 != 0 ||
      (n_frames - 1) * kHop + kNfft > n_buf || lay.total > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(buf) | reinterpret_cast<uintptr_t>(window) |
       reinterpret_cast<uintptr_t>(twiddles) |
       reinterpret_cast<uintptr_t>(weights)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static dyn_smem::Limit limit;  // per device (smem_limit.cuh)
  if (const cudaError_t e = dyn_smem::allow(mel_frames_kernel, lay.total,
                                            limit, 48 * 1024))
    return static_cast<int>(e);
  const dim3 grid((n_frames + frames_per_block - 1) / frames_per_block,
                  batch);
  mel_frames_kernel<<<grid, kLanes * lay.frames, lay.total,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), static_cast<const float*>(window),
      static_cast<const double2*>(twiddles),
      static_cast<const float*>(weights), static_cast<const int4*>(bands),
      static_cast<float*>(out), n_buf, n_frames, n_mels, n_w,
      frames_per_block);
  return static_cast<int>(cudaGetLastError());
}
