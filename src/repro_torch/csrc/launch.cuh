// What every C entry point shares: how its arguments arrive, and the kernel
// attributes it sets once rather than on every launch.
//
// Arguments.  Each entry point takes `(const long long* a, int count)`: one
// array of 64-bit integers holding the call's pointers, sizes and flags in a
// fixed order, the stream last, packed by kernels/runtime.py with `struct`.
// One array costs ctypes two conversions per call instead of one per
// argument (up to 26).  An entry point returns kBadArgCount if `count` is not
// the number it reads.
//
// Attributes.  A kernel that uses more than 48 KB of dynamic shared memory
// must say so with cudaFuncSetAttribute before its launch.  That call costs
// microseconds, so it is made once per kernel instantiation, device and
// size: `done`, a static array of the caller (one per instantiation),
// remembers what was set on each device.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kBadArgCount = -3;
constexpr int kMaxDevices = 32;

template <typename T>
inline T* arg_ptr(long long v) {
  return reinterpret_cast<T*>(static_cast<intptr_t>(v));
}

inline cudaStream_t arg_stream(long long v) { return arg_ptr<CUstream_st>(v); }

// Raises the kernel's dynamic shared-memory limit to `bytes` on the current
// device, unless a limit at least that large was set there already.
// Returns the CUDA error of the call, or 0.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes, int (&done)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  done[dev] = bytes;
  return 0;
}

}  // namespace repro
