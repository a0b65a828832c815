// int8 x int8 matrix product with int32 accumulation and per-row /
// per-column f32 scales: out[m][n] = (float(sum_k x[m][k] * w[k][n]) * sx[m]) * sw[n].
//
// Replaces: the Pallas TPU kernel `_kernel` launched by `_int8_matmul_call`
// in the JAX package's kernels/int8_matmul.py (public `int8_matmul`), which
// the serving path reaches through models/quant.py:qeinsum for every
// quantized projection.
//
// Bound on an H100: at decode (M = a few rows) the weights dominate the
// bytes, K*N int8 read once, so bytes (a 4096 x 12800 weight is 52 MB,
// 16 us at 3.35 TB/s); at prefill (M of a few hundred) the 2*M*K*N integer
// operations over the tensor cores' 1979 TOP/s, which this first kernel does
// not use: it runs on `__dp4a` (four byte products and a sum per
// instruction), so at large M it is bound by that instruction's rate.
//
// Design: one block of 256 threads per (BM x 64) output tile, with the whole
// K loop inside the block and the tile's 16 int32 accumulators per thread in
// registers: the TPU kernel's sequential K grid axis and its VMEM
// accumulator have no counterpart here.  Each 128-byte slice of K is staged
// in shared memory; the next slice is fetched into registers while the
// current one is multiplied.  `dp4a` wants four consecutive k of one column
// in one register, but w is stored (K, N) with n contiguous, so each thread
// reads a 4 x 4 byte block of w (four rows of four columns) and transposes
// it with byte permutes on its way into shared memory; no transposed copy of
// the weights is kept.  x rows are already k-contiguous.  BM is 16 when M is
// small (decode) and 64 otherwise.  Ragged M, N and K are masked: loads past
// an edge read zeros, stores past an edge are skipped.  The epilogue
// multiplies in the reference's order with round-to-nearest conversions,
// which makes the result bit-identical to the plain version.
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;            // output columns of a tile
constexpr int kBK = 128;           // bytes of k staged per step
constexpr int kKQ = kBK / 4;       // k quads per step
constexpr int kPad = kKQ + 1;      // row stride of the shared tiles, in words

// Four consecutive bytes of `row` from `k` on, little-endian, zeros past `len`.
__device__ __forceinline__ int32_t load4(const int8_t* row, long long k, long long len,
                                         bool vec) {
  if (vec && k + 3 < len) return *reinterpret_cast<const int32_t*>(row + k);
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < len) v |= static_cast<uint32_t>(static_cast<uint8_t>(row[k + j])) << (8 * j);
  return static_cast<int32_t>(v);
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   float* __restrict__ out, int M, int N, int K, int vec_x, int vec_w) {
  constexpr int BM = 16 * TM;
  constexpr int A_PER_THREAD = BM * kKQ / kThreads;        // words of x per thread
  constexpr int B_PER_THREAD = kKQ * (kBN / 4) / kThreads;  // 4x4 byte blocks of w per thread
  static_assert(A_PER_THREAD >= 1 && B_PER_THREAD >= 1, "tile too small for the block");
  __shared__ __align__(16) int32_t As[BM][kPad];
  __shared__ __align__(16) int32_t Bs[kBN][kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;

  int32_t a_reg[A_PER_THREAD];
  int32_t b_reg[B_PER_THREAD][4];

  auto fetch = [&](long long k0) {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kKQ, kq = e % kKQ;
      const long long m = m0 + r;
      a_reg[i] = m < M ? load4(xq + m * K, k0 + 4 * kq, K, vec_x) : 0;
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int e = tid + i * kThreads;
      const int kq = e / (kBN / 4), nq = e % (kBN / 4);
      const long long n = n0 + 4 * nq;
      int32_t rows[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long k = k0 + 4 * kq + j;
        rows[j] = k < K ? load4(wq + k * N, n, N, vec_w) : 0;
      }
      // 4 x 4 byte transpose: word c of the result holds column n + c for
      // k .. k+3, byte j = row k + j (the byte order of an x word).
      const uint32_t t0 = __byte_perm(rows[0], rows[1], 0x5140);
      const uint32_t t1 = __byte_perm(rows[0], rows[1], 0x7362);
      const uint32_t t2 = __byte_perm(rows[2], rows[3], 0x5140);
      const uint32_t t3 = __byte_perm(rows[2], rows[3], 0x7362);
      b_reg[i][0] = static_cast<int32_t>(__byte_perm(t0, t2, 0x5410));
      b_reg[i][1] = static_cast<int32_t>(__byte_perm(t0, t2, 0x7632));
      b_reg[i][2] = static_cast<int32_t>(__byte_perm(t1, t3, 0x5410));
      b_reg[i][3] = static_cast<int32_t>(__byte_perm(t1, t3, 0x7632));
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int e = tid + i * kThreads;
      As[e / kKQ][e % kKQ] = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int e = tid + i * kThreads;
      const int kq = e / (kBN / 4), nq = e % (kBN / 4);
#pragma unroll
      for (int c = 0; c < 4; ++c) Bs[4 * nq + c][kq] = b_reg[i][c];
    }
  };

  int32_t acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  fetch(0);
  stage();
  __syncthreads();
  for (long long k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) fetch(k0 + kBK);
#pragma unroll 8
    for (int kq = 0; kq < kKQ; ++kq) {
      int32_t a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[ty * TM + i][kq];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][kq];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
    const float row_scale = sx[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n < N)
        out[m * N + n] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), row_scale), sw[n]);
    }
  }
}

template <int TM>
int launch(const int8_t* xq, const int8_t* wq, const float* sx, const float* sw, float* out,
           int M, int N, int K, int vec_x, int vec_w, cudaStream_t s) {
  constexpr int BM = 16 * TM;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  int8_matmul_kernel<TM><<<grid, kThreads, 0, s>>>(xq, wq, sx, sw, out, M, N, K, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// x_q: (M, K) int8; w_q: (K, N) int8; x_scale: (M) f32; w_scale: (N) f32;
// out: (M, N) f32; all contiguous.  vec_x / vec_w: 1 if every row of x / w
// may be read as aligned 4-byte words (K % 4 == 0, resp. N % 4 == 0, and
// 4-byte aligned base pointers).  block_m is 16 or 64.  Returns -2 for
// arguments it does not take, else cudaGetLastError() after the launch.
extern "C" int repro_int8_matmul(const void* x_q, const void* w_q, const void* x_scale,
                                 const void* w_scale, void* out, int M, int N, int K,
                                 int vec_x, int vec_w, int block_m, void* stream) {
  using namespace repro;
  if (M < 1 || N < 1 || K < 1 || M > 65535 * 16) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xq = static_cast<const int8_t*>(x_q);
  const auto* wq = static_cast<const int8_t*>(w_q);
  const auto* sx = static_cast<const float*>(x_scale);
  const auto* sw = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  if (block_m == 16) return launch<1>(xq, wq, sx, sw, o, M, N, K, vec_x, vec_w, s);
  if (block_m == 64) return launch<4>(xq, wq, sx, sw, o, M, N, K, vec_x, vec_w, s);
  return -2;
}
