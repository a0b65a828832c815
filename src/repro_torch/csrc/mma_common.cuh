// PTX helpers shared by the tensor-core kernels (flash_attention.cu,
// int8_matmul.cu): 16-byte cp.async copies into shared memory, ldmatrix
// fragment loads, the rounding of f32 to TF32 and the three warp-level mma
// shapes they use.  All of them exist on sm_80 and later; the library is
// built for sm_90a.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace repro {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes from global to shared memory without passing through
// registers; only the first `src_bytes` (0 or 16) are read, the rest of the
// 16 are filled with zeros.  `src` must be a valid address even when 0
// bytes are read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit elements (or 8x16 bytes) from shared memory;
// lane l gives the address of row l % 8 of matrix l / 8.  Lane l receives,
// of each matrix, row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, transposed: lane l receives of each matrix column l / 4, rows
// 2 (l % 4) and 2 (l % 4) + 1.  For 16-bit elements only.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// the result is an f32 whose low 13 mantissa bits are zero.  Half a unit of
// the kept bits is added to the bit pattern, then the dropped bits are
// cleared: the value of `cvt.rna.tf32.f32` for every input but a NaN (a
// carry into the exponent gives the next power of two, or infinity), in two
// integer operations, where cvt.rna compiles to these two plus a NaN test
// and a select.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), f32 accumulators.  Lane l
// (g = l / 4, t = l % 4) holds a = {A[g][t], A[g + 8][t], A[g][t + 4],
// A[g + 8][t + 4]}, b = {B[t][g], B[t + 4][g]}, d = {D[g][2t], D[g][2t + 1],
// D[g + 8][2t], D[g + 8][2t + 1]}.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulators (exact).
__device__ __forceinline__ void mma_s8_16832(int32_t (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
}  // namespace repro
