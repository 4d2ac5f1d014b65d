// The dynamic shared memory a kernel may launch with, raised on each card.
//
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) acts on the current
// device only. A process that launches one kernel on several cards (a dp
// mesh, parallel/mesh.py) raises it on each, so the limit a launcher has
// set is kept per device: dyn_smem::allow(kernel, bytes, limit, floor)
// before each launch, with one `static dyn_smem::Limit` per kernel
// (instantiation).
// It sets the attribute only where `bytes` exceeds both `floor` (what the
// kernel may take unasked: 48 KB, or 0 to set it on first use) and what
// this device was given before. Not a stream operation: a CUDA graph's
// capture may call it.

#pragma once

#include <cuda_runtime.h>

namespace dyn_smem {

constexpr int kMaxDevices = 64;

struct Limit {
  int bytes[kMaxDevices] = {};  // the largest set so far, per device
};

template <typename Kernel>
inline cudaError_t allow(Kernel kernel, int bytes, Limit& limit, int floor) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* got = dev < kMaxDevices ? &limit.bytes[dev] : nullptr;
  if (bytes <= floor || (got != nullptr && bytes <= *got)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && got != nullptr) *got = bytes;
  return e;
}

}  // namespace dyn_smem
