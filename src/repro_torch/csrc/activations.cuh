// Activation-implementation variants as device functions (paper RQ1).
//
// One definition of `apply_variant`, shared by the elementwise kernel in
// activations.cu and by the gate epilogues of lstm_cell.cu and lstm_seq.cu.
// It mirrors `_apply_variant` of the JAX package's kernels/activations.py:
// tanh is 2*sigmoid(2x) - 1 for exact, pwl and lut, and clip(x, -1, 1) for
// hard.  Compiled WITHOUT --use_fast_math: the exact sigmoid needs an IEEE
// division and the table index a true division and round-half-to-even.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kLutSize = 256;       // entries of the half-range sigmoid table
constexpr float kLutRange = 8.0f;   // the table covers [0, 8]

enum Impl : int { kExact = 0, kPwl = 1, kLut = 2, kHard = 3 };
enum Fn : int { kSigmoid = 0, kTanh = 1, kSilu = 2, kGelu = 3 };

__device__ __forceinline__ float sigmoid_exact(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// PLAN piecewise-linear sigmoid, symmetric around 0.
__device__ __forceinline__ float sigmoid_pwl(float x) {
  const float a = fabsf(x);
  float y;
  if (a >= 5.0f) {
    y = 1.0f;
  } else if (a >= 2.375f) {
    y = 0.03125f * a + 0.84375f;
  } else if (a >= 1.0f) {
    y = 0.125f * a + 0.625f;
  } else {
    y = 0.25f * a + 0.5f;
  }
  return x >= 0.0f ? y : 1.0f - y;
}

// relu6(x + 3) / 6
__device__ __forceinline__ float sigmoid_hard(float x) {
  return fminf(fmaxf(x + 3.0f, 0.0f), 6.0f) / 6.0f;
}

// Nearest-entry lookup in the half-range table with sign reflection.  The
// TPU kernel gathers with a one-hot product because it has no indexed load;
// here the table sits in shared memory and is simply indexed: same values.
// rintf rounds half to even, as the reference's index computation does.
__device__ __forceinline__ float sigmoid_lut(float x, const float* table) {
  const float a = fminf(fmaxf(fabsf(x), 0.0f), kLutRange);
  const int idx = static_cast<int>(rintf(a / kLutRange * (kLutSize - 1)));
  const float y = table[idx];
  return x >= 0.0f ? y : 1.0f - y;
}

// fn is kSigmoid or kTanh; `table` is only read when impl == kLut.
__device__ __forceinline__ float apply_variant(float x, int impl, int fn,
                                               const float* table) {
  const bool is_tanh = (fn == kTanh);
  if (impl == kHard && is_tanh) return fminf(fmaxf(x, -1.0f), 1.0f);
  const float arg = is_tanh ? 2.0f * x : x;
  float s;
  switch (impl) {
    case kPwl:  s = sigmoid_pwl(arg); break;
    case kLut:  s = sigmoid_lut(arg, table); break;
    case kHard: s = sigmoid_hard(arg); break;
    default:    s = sigmoid_exact(arg); break;
  }
  return is_tanh ? 2.0f * s - 1.0f : s;
}

// Cooperative copy of the table from device memory into shared memory.  The
// caller synchronises the block before the first lookup.
__device__ __forceinline__ void load_table(float* table_s, const float* table_g) {
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < kLutSize; i += nthreads) table_s[i] = table_g[i];
}

}  // namespace repro
