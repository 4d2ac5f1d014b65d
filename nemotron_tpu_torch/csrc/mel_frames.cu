// Log-mel frames of pre-emphasized audio for Hopper, sm_90a.
//
// Replaces: nemotron_tpu/ops/mel_pallas.py, _mel_kernel via
// mel_frames_pallas (pallas_call at :84), the kernel behind
// make_mel_step_pallas. Same function: for stream b and frame t
//     x[n]   = buf[b, t*160 + n] * window512[n]           n < 512
//     re[k]  = sum_n x[n] cos_t[n, k],  im[k] = sum_n x[n] sin_t[n, k]
//     p[k]   = re[k]^2 + im[k]^2                          k < 257
//     out[m] = log(sum_k p[k] fb_t[k, m] + 2^-24)         m < n_mels
// cos_t / sin_t are the f32 DFT tables of ops/mel.dft_bases, read from
// device memory rather than recomputed with sincos, so the kernel matches
// the reference at the f32 level. No TF32 anywhere. The Pallas kernel's
// padding of 257 bins to 384 existed for TPU lanes and is not carried over.
//
// What bounds it on the H100: neither HBM nor FLOPs at serving sizes — the
// audio is 6.5 KB per stream and the DFT is 2*512*257 FMAs per frame. The
// DFT tables (2 x 512 x 257 f32 = 1 MB) are read by every block and stay
// in the 50 MB L2, so the limit is L2 bandwidth and, at small B, launch
// latency and the number of blocks in flight.
//
// Design (first version): one block per (stream, frame) with 288 threads
// (9 warps, one thread per DFT bin); the windowed frame sits in shared
// memory and is broadcast to every thread; for fixed n the bins' table
// reads are contiguous (coalesced); the 257 powers go to shared memory;
// threads m < n_mels then reduce the filterbank column fb_t[:, m]
// (coalesced across m) and take the log.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNfft = 512;
constexpr int kHop = 160;
constexpr int kBins = kNfft / 2 + 1;  // 257
constexpr int kThreads = 288;         // >= kBins, whole warps
constexpr float kLogGuard = 5.9604644775390625e-8f;  // 2^-24

__global__ void __launch_bounds__(kThreads)
mel_frames_kernel(const float* __restrict__ buf,
                  const float* __restrict__ window,
                  const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t,
                  const float* __restrict__ fb_t, float* __restrict__ out,
                  int n_buf, int n_frames, int n_mels) {
  __shared__ float frame[kNfft];
  __shared__ float power[kBins];

  const int b = blockIdx.x / n_frames;
  const int t = blockIdx.x % n_frames;
  const int tid = threadIdx.x;
  const float* src = buf + (long)b * n_buf + (long)t * kHop;

  for (int n = tid; n < kNfft; n += kThreads) frame[n] = src[n] * window[n];
  __syncthreads();

  if (tid < kBins) {
    float re = 0.f, im = 0.f;
    for (int n = 0; n < kNfft; ++n) {
      const float x = frame[n];
      re = fmaf(x, cos_t[n * kBins + tid], re);
      im = fmaf(x, sin_t[n * kBins + tid], im);
    }
    power[tid] = re * re + im * im;
  }
  __syncthreads();

  for (int m = tid; m < n_mels; m += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < kBins; ++k) acc = fmaf(power[k], fb_t[k * n_mels + m], acc);
    out[((long)b * n_frames + t) * n_mels + m] = logf(acc + kLogGuard);
  }
}

}  // namespace

extern "C" int mel_frames_f32(const void* buf, const void* window,
                              const void* cos_t, const void* sin_t,
                              const void* fb_t, void* out, int batch,
                              int n_buf, int n_frames, int n_mels,
                              void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  if ((n_frames - 1) * kHop + kNfft > n_buf) return (int)cudaErrorInvalidValue;
  mel_frames_kernel<<<batch * n_frames, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), static_cast<const float*>(window),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const float*>(fb_t), static_cast<float*>(out), n_buf,
      n_frames, n_mels);
  return static_cast<int>(cudaGetLastError());
}
