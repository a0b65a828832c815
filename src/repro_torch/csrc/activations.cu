// Elementwise activation variants: sigmoid, tanh, silu, gelu under
// exact / pwl / lut / hard.
//
// Replaces: the Pallas TPU kernel `_kernel` launched by `_activation_call`
// in the JAX package's kernels/activations.py (public `activation`).
//
// Bound on an H100: bytes.  Each element is read once and written once and
// costs at most one expf and one division, so the floor is 2 * n * sizeof(T)
// over the card's memory rate.
//
// Design: a grid-stride loop over 16-byte vectors (4 floats or 8 bf16) with
// a scalar tail, neighbouring threads on neighbouring addresses; arithmetic
// in f32 whatever the storage type.  The TPU kernel tiles a (rows, lanes)
// view and pads ragged rows; a flat index needs neither, so no padded copy
// is made and no element past `n` is touched.  The 256-entry table is
// copied to shared memory once per block, only for impl == lut.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"
#include "launch.cuh"

namespace repro {
namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float activate(float x, int fn, int impl, const float* table) {
  if (fn == kSilu) return x * apply_variant(x, impl, kSigmoid, table);
  if (fn == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    // Rounded product by product, never contracted into multiply-adds: the
    // lut variant is discontinuous in `inner`, so its last bit must be the
    // plain version's, or the lookup can land in the neighbouring bin.
    const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
    const float inner = __fmul_rn(c, __fadd_rn(x, cube));
    return 0.5f * x * (1.0f + apply_variant(inner, impl, kTanh, table));
  }
  return apply_variant(x, impl, fn, table);
}

template <typename T>
__global__ void activation_kernel(const T* __restrict__ x, T* __restrict__ y,
                                  long long n, int fn, int impl, int vectorised,
                                  const float* __restrict__ table_g) {
  __shared__ float table_s[kLutSize];
  if (impl == kLut) {
    load_table(table_s, table_g);
    __syncthreads();
  }
  constexpr int kVec = 16 / sizeof(T);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vectorised) {
    const long long nvec = n / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (long long v = first; v < nvec; v += stride) {
      uint4 in = xv[v];
      uint4 out;
      const T* pi = reinterpret_cast<const T*>(&in);
      T* po = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int e = 0; e < kVec; ++e) from_f32(activate(to_f32(pi[e]), fn, impl, table_s), po + e);
      yv[v] = out;
    }
    done = nvec * kVec;
  }
  for (long long i = done + first; i < n; i += stride) {
    from_f32(activate(to_f32(x[i]), fn, impl, table_s), y + i);
  }
}

}  // namespace
}  // namespace repro

// a = {x, y, n, fn, impl, is_bf16, table, stream}: x, y hold n contiguous
// elements, f32 (is_bf16 == 0) or bf16 (is_bf16 == 1); table is read only
// for impl == lut.  Returns cudaGetLastError() after the launch.
extern "C" int repro_activation(const long long* a, int count) {
  using namespace repro;
  if (count != 8) return kBadArgCount;
  const void* x = arg_ptr<const void>(a[0]);
  void* y = arg_ptr<void>(a[1]);
  const long long n = a[2];
  const int fn = static_cast<int>(a[3]), impl = static_cast<int>(a[4]);
  const int is_bf16 = static_cast<int>(a[5]);
  const float* t = arg_ptr<const float>(a[6]);
  cudaStream_t s = arg_stream(a[7]);
  if (n <= 0) return 0;
  const int threads = 256;
  const int elems_per_thread = is_bf16 ? 8 : 4;
  long long want = (n + static_cast<long long>(threads) * elems_per_thread - 1) /
                   (static_cast<long long>(threads) * elems_per_thread);
  const long long cap = 132LL * 16;  // a few waves of blocks; the loop strides over the rest
  const int blocks = static_cast<int>(want < 1 ? 1 : (want > cap ? cap : want));
  const int vectorised =
      (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (is_bf16) {
    activation_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, fn, impl,
        vectorised, t);
  } else {
    activation_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, fn, impl, vectorised, t);
  }
  return static_cast<int>(cudaGetLastError());
}
