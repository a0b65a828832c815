// int8 x int8 matrix product with int32 accumulation and per-row /
// per-column f32 scales: out[m][n] = (float(sum_k x[m][k] * w[k][n]) * sx[m]) * sw[n].
//
// Replaces: the Pallas TPU kernel `_kernel` launched by `_int8_matmul_call`
// in the JAX package's kernels/int8_matmul.py (public `int8_matmul`), which
// the serving path reaches through models/quant.py:qeinsum for every
// quantized projection.
//
// Bound on an H100: at decode (M = a few rows) bytes, the K*N int8 weight
// read once (a 4096 x 12800 weight is 52 MB, 16 us at 3.35 TB/s); at
// prefill (M of a few hundred) the 2*M*K*N integer operations over the
// tensor cores' 1979 TOP/s, or the weight bytes, whichever is larger.
//
// What held the first (PR 12) design back (PERF.md, NVIDIA H100 80GB HBM3,
// 700 W): it multiplied on `__dp4a`, 39 TOP/s at M = 256 (0.682 ms for
// 4096 x 12800 against 0.312 ms for torch._int_mm); and at decode each
// block walked the whole of K in serial 128-byte steps with one step in
// flight, 1.7-2.6 us a step, on as few as 16 blocks (N / 64 for wk/wv):
// 0.0825 ms for 4096 x 12800 against a 0.0157 ms bound, 0.215 ms for
// 12800 x 4096.
//
// Design.  Products run on the tensor cores as `mma.sync` m16n8k32 s8 x s8
// -> s32; M is padded inside the tile (16 rows at decode, where the padding
// costs nothing that bounds the kernel; 64 or 128 columns, so that a block
// reads 64 or 128 contiguous bytes of each weight row).  x and w tiles of 64 bytes of k
// arrive through a 4-stage ring of 16-byte cp.async copies, so 3 stages are
// in flight while one is multiplied.  The int8 B operand of `mma` must be
// k-contiguous per output column, but w is stored (K, N) with n contiguous,
// and no ldmatrix transpose exists for 8-bit types: each stage's raw w tile
// is transposed shared -> shared, 16 k x 4 n bytes per thread (four 4 x 4
// byte transposes by `__byte_perm`, four 16-byte stores); no transposed copy
// of the weights exists in device memory.  The x tile and the transposed w
// tile use 64-byte rows whose 16-byte chunks are XOR-swizzled by row, so
// that the 8 rows one ldmatrix reads fall in 8 distinct bank groups.
//
// Split-K.  The plan (kernels/int8_matmul.py:plan) cuts K into `split_k`
// chunks of `k_chunk` bytes (a multiple of 64), one per grid z, so that the
// grid has about 2 x 132 blocks at decode and one wave at larger M.  With
// more than one chunk, each block adds its int32 partial sums into the
// tile's slice of an int32 workspace with atomics (integer addition is
// exact and associative, so the sum has the same bits in any order), then
// counts its arrival on the tile's counter; the last block to arrive
// applies the epilogue and puts the workspace slice and the counter back to
// zero.  One launch per call: no memset, no second reduction kernel.  The
// workspace and counters belong to the wrapper, which allocates them zeroed
// once and reuses them.
//
// Batch.  A call may hold E independent products of one shape, x (E, M, K),
// w (E, K, N), x scales (E, M), w scales (E, N), out (E, M, N): the MoE
// expert einsums, which the reference runs as `jax.vmap` of its pallas_call,
// one launch with a batch grid axis.  Here too it is one launch: the batch
// index is folded into grid z with the split-K chunk (z = e * split_k +
// chunk), and each batch index has its own slice of the split-K workspace
// and counters.  x and its scales are either stacked, one per product, or
// shared by every product (x_shared): the MoE dense path hands every expert
// the same token block, quantized once.
//
// Ragged M, N and K are masked: loads past an edge read zeros (K and N
// multiples of 16 take the cp.async path; other shapes load bytes one by
// one), stores past an edge are skipped.  The epilogue multiplies in the
// reference's order with round-to-nearest conversions,
// __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw), which makes the
// result bit-identical to the plain version.
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_common.cuh"

namespace repro {
namespace {

constexpr int kBK = 64;      // bytes of k per stage; a multiple of the mma's 32
constexpr int kStages = 4;   // ring depth

// Byte offset of 16-byte chunk c (0..3) of row r in a tile of 64-byte rows.
// Rows 8a .. 8a + 7 read at one chunk land in 8 distinct bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBK + ((c ^ (((r >> 1) ^ (r >> 3)) & 3)) << 4);
}

template <int BM, int BN>
constexpr int smem_bytes() {
  return kStages * (BM * kBK + kBK * BN) + BN * kBK;
}

__device__ __forceinline__ float epilogue(int32_t acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
int8_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   float* __restrict__ out, int32_t* __restrict__ ws,
                   int32_t* __restrict__ counters, int M, int N, int K, int k_chunk,
                   int split_k, int x_shared) {
  constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;  // a warp's tile
  constexpr int TM = WTM / 16, TN = WTN / 8;             // its mma tiles
  static_assert(TM >= 1 && TN >= 2 && TN % 2 == 0, "warp tile too small");
  constexpr int A_BYTES = BM * kBK, W_BYTES = kBK * BN;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* a_s = smem;                         // [stage][BM][64], swizzled
  unsigned char* w_s = smem + kStages * A_BYTES;     // [stage][64][BN], as stored
  unsigned char* b_s = w_s + kStages * W_BYTES;      // [BN][64], k contiguous, swizzled
  __shared__ int last_arrival;

  // this block's product of the batch and its chunk of K
  const int batch = blockIdx.z / split_k, chunk = blockIdx.z % split_k;
  const long long xb = x_shared ? 0 : batch;
  xq += xb * M * K;
  wq += batch * static_cast<long long>(K) * N;
  sx += xb * M;
  sw += static_cast<long long>(batch) * N;
  out += batch * static_cast<long long>(M) * N;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, t = lane % 4;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;
  const long long k_begin = static_cast<long long>(chunk) * k_chunk;
  const long long k_stop = min(static_cast<long long>(K), k_begin + k_chunk);
  const int steps = static_cast<int>((k_stop - k_begin + kBK - 1) / kBK);

  auto load_stage = [&](int step, int slot) {
    const long long k0 = k_begin + static_cast<long long>(step) * kBK;
    unsigned char* as = a_s + slot * A_BYTES;
    unsigned char* raw = w_s + slot * W_BYTES;
    if constexpr (VEC) {
      for (int e = tid; e < BM * 4; e += THREADS) {
        const int r = e / 4, c = e % 4;
        const long long m = m0 + r, k = k0 + 16 * c;
        const bool in = m < M && k < k_stop;
        mma::cp_async16(as + swz(r, c), in ? xq + m * K + k : xq, in ? 16 : 0);
      }
      for (int e = tid; e < kBK * (BN / 16); e += THREADS) {
        const int r = e / (BN / 16), c = e % (BN / 16);
        const long long k = k0 + r, n = n0 + 16 * c;
        const bool in = k < k_stop && n < N;
        mma::cp_async16(raw + r * BN + 16 * c, in ? wq + k * N + n : wq, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * (kBK / 4); e += THREADS) {
        const int r = e / (kBK / 4), word = e % (kBK / 4);
        const long long m = m0 + r;
        uint32_t val = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long k = k0 + 4 * word + j;
          if (m < M && k < k_stop)
            val |= static_cast<uint32_t>(static_cast<uint8_t>(xq[m * K + k])) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(as + swz(r, word / 4) + 4 * (word % 4)) = val;
      }
      for (int e = tid; e < kBK * (BN / 4); e += THREADS) {
        const int r = e / (BN / 4), word = e % (BN / 4);
        const long long k = k0 + r;
        uint32_t val = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long n = n0 + 4 * word + j;
          if (k < k_stop && n < N)
            val |= static_cast<uint32_t>(static_cast<uint8_t>(wq[k * N + n])) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(raw + r * BN + 4 * word) = val;
      }
    }
  };

  // raw (64 k x BN n) -> b_s (BN rows of 64 k), 16 k x 4 n bytes per thread
  auto transpose = [&](int slot) {
    const unsigned char* raw = w_s + slot * W_BYTES;
    for (int e = tid; e < BN; e += THREADS) {
      const int nq = e % (BN / 4), kc = e / (BN / 4);
      uint32_t col[4][4];  // [column][k quad]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t rows[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rows[j] = *reinterpret_cast<const uint32_t*>(raw + (16 * kc + 4 * q + j) * BN + 4 * nq);
        // 4 x 4 byte transpose: word c holds column 4 nq + c for k .. k + 3,
        // byte j = row k + j (little-endian: k-contiguous in memory)
        const uint32_t t0 = __byte_perm(rows[0], rows[1], 0x5140);
        const uint32_t t1 = __byte_perm(rows[0], rows[1], 0x7362);
        const uint32_t t2 = __byte_perm(rows[2], rows[3], 0x5140);
        const uint32_t t3 = __byte_perm(rows[2], rows[3], 0x7362);
        col[0][q] = __byte_perm(t0, t2, 0x5410);
        col[1][q] = __byte_perm(t0, t2, 0x7632);
        col[2][q] = __byte_perm(t1, t3, 0x5410);
        col[3][q] = __byte_perm(t1, t3, 0x7632);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint4*>(b_s + swz(4 * nq + c, kc)) =
            make_uint4(col[c][0], col[c][1], col[c][2], col[c][3]);
    }
  };

  int32_t acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    mma::cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `step` has landed; every thread is done with step - 1
    const int next = step + kStages - 1;
    if (next < steps) load_stage(next, next % kStages);
    mma::cp_async_commit();
    const int slot = step % kStages;
    transpose(slot);
    __syncthreads();
    const unsigned char* as = a_s + slot * A_BYTES;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[TM][4], bf[TN][2];
#pragma unroll
      for (int tm = 0; tm < TM; ++tm)
        mma::ldmatrix_x4(af[tm], as + swz(wm * WTM + 16 * tm + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
      for (int tn = 0; tn < TN; tn += 2) {
        uint32_t r[4];  // columns 8 tn .. 8 tn + 15 of the warp, k 32 ks .. 32 ks + 31
        mma::ldmatrix_x4(r, b_s + swz(wn * WTN + 8 * tn + (lane & 7) + 8 * (lane >> 4),
                                      2 * ks + ((lane >> 3) & 1)));
        bf[tn][0] = r[0]; bf[tn][1] = r[1]; bf[tn + 1][0] = r[2]; bf[tn + 1][1] = r[3];
      }
#pragma unroll
      for (int tm = 0; tm < TM; ++tm)
#pragma unroll
        for (int tn = 0; tn < TN; ++tn)
          mma::mma_s8_16832(acc[tm][tn], af[tm], bf[tn][0], bf[tn][1]);
    }
  }

  // Accumulator acc[tm][tn][2 h + e] is row 16 tm + g + 8 h, column 8 tn + 2 t + e
  // of the warp's tile.
  if (split_k == 1) {
#pragma unroll
    for (int tm = 0; tm < TM; ++tm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * WTM + 16 * tm + g + 8 * h;
        if (m >= M) continue;
        const float row_scale = sx[m];
#pragma unroll
        for (int tn = 0; tn < TN; ++tn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long long n = n0 + wn * WTN + 8 * tn + 2 * t + e;
            if (n < N) out[m * N + n] = epilogue(acc[tm][tn][2 * h + e], row_scale, sw[n]);
          }
      }
    return;
  }

  const int tile = (batch * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  int32_t* tile_ws = ws + static_cast<long long>(tile) * BM * BN;
#pragma unroll
  for (int tm = 0; tm < TM; ++tm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * WTM + 16 * tm + g + 8 * h;
      if (m0 + r >= M) continue;
#pragma unroll
      for (int tn = 0; tn < TN; ++tn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn * WTN + 8 * tn + 2 * t + e;
          if (n0 + c < N) atomicAdd(tile_ws + r * BN + c, acc[tm][tn][2 * h + e]);
        }
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_arrival = atomicAdd(counters + tile, 1) == split_k - 1;
  __syncthreads();
  if (!last_arrival) return;
  __threadfence();
#pragma unroll
  for (int tm = 0; tm < TM; ++tm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * WTM + 16 * tm + g + 8 * h;
      const long long m = m0 + r;
      if (m >= M) continue;
      const float row_scale = sx[m];
#pragma unroll
      for (int tn = 0; tn < TN; ++tn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn * WTN + 8 * tn + 2 * t + e;
          const long long n = n0 + c;
          if (n >= N) continue;
          int32_t* slot = tile_ws + r * BN + c;
          out[m * N + n] = epilogue(__ldcg(slot), row_scale, sw[n]);
          __stcg(slot, 0);
        }
    }
  if (tid == 0) counters[tile] = 0;
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
int launch(const int8_t* xq, const int8_t* wq, const float* sx, const float* sw, float* out,
           int32_t* ws, int32_t* counters, int M, int N, int K, int vec, int split_k,
           int k_chunk, int batch, int x_shared, cudaStream_t s) {
  constexpr int smem = smem_bytes<BM, BN>();
  static int smem_set[2][kMaxDevices] = {};
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch * split_k);
  if (grid.y > 65535) return -2;
  if (vec) {
    auto kernel = int8_matmul_kernel<BM, BN, WARPS_M, WARPS_N, true>;
    const int rc = allow_smem(kernel, smem, smem_set[1]);
    if (rc != 0) return rc;
    kernel<<<grid, 32 * WARPS_M * WARPS_N, smem, s>>>(xq, wq, sx, sw, out, ws, counters, M, N, K,
                                                       k_chunk, split_k, x_shared);
  } else {
    auto kernel = int8_matmul_kernel<BM, BN, WARPS_M, WARPS_N, false>;
    const int rc = allow_smem(kernel, smem, smem_set[0]);
    if (rc != 0) return rc;
    kernel<<<grid, 32 * WARPS_M * WARPS_N, smem, s>>>(xq, wq, sx, sw, out, ws, counters, M, N, K,
                                                       k_chunk, split_k, x_shared);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// a = {x_q, w_q, x_scale, w_scale, out, workspace, counters, M, N, K, vec,
// block_m, block_n, split_k, k_chunk, batch, x_shared, stream}.
// E = batch products of one shape: x_q: (E, M, K) int8 and x_scale: (E, M)
// f32, or with x_shared = 1 one (M, K) x_q and one (M) x_scale for every
// product; w_q: (E, K, N) int8; w_scale: (E, N) f32; out: (E, M, N) f32;
// each product contiguous.
// vec: 1 if K and N are multiples of 16 and x_q and w_q start on 16-byte
// boundaries.  The plan, from kernels/int8_matmul.py:plan: (block_m, block_n)
// one of (16, 64), (16, 128), (64, 128), (128, 128); K cut into split_k chunks
// of k_chunk bytes, a positive multiple of 64, the last one non-empty;
// batch * split_k <= 65535.  With split_k > 1, workspace holds E *
// ceil(M / block_m) * ceil(N / block_n) * block_m * block_n int32 and
// counters one int32 per tile of each product, all zero, and the kernel
// leaves them zero.  K <= 131071, so that no int32 sum of int8 products
// overflows.  Returns -2 for a plan or arguments it does not take, else the
// CUDA error of the launch.
extern "C" int repro_int8_matmul(const long long* a, int count) {
  using namespace repro;
  if (count != 18) return kBadArgCount;
  const void* x_q = arg_ptr<const void>(a[0]);
  const void* w_q = arg_ptr<const void>(a[1]);
  const void* x_scale = arg_ptr<const void>(a[2]);
  const void* w_scale = arg_ptr<const void>(a[3]);
  void* out = arg_ptr<void>(a[4]);
  void* workspace = arg_ptr<void>(a[5]);
  void* counters = arg_ptr<void>(a[6]);
  const int M = static_cast<int>(a[7]), N = static_cast<int>(a[8]), K = static_cast<int>(a[9]);
  const int vec = static_cast<int>(a[10]), block_m = static_cast<int>(a[11]);
  const int block_n = static_cast<int>(a[12]), split_k = static_cast<int>(a[13]);
  const int k_chunk = static_cast<int>(a[14]), batch = static_cast<int>(a[15]);
  const int x_shared = static_cast<int>(a[16]);
  cudaStream_t s = arg_stream(a[17]);
  if (M < 1 || N < 1 || K < 1 || K > 131071) return -2;
  if (k_chunk < kBK || k_chunk % kBK || split_k < 1 || split_k > 65535) return -2;
  if (batch < 1 || static_cast<long long>(batch) * split_k > 65535) return -2;
  if (x_shared != 0 && x_shared != 1) return -2;
  if (static_cast<long long>(split_k) * k_chunk < K ||
      static_cast<long long>(split_k - 1) * k_chunk >= K)
    return -2;
  if (split_k > 1 && (workspace == nullptr || counters == nullptr)) return -2;
  const auto* xq = static_cast<const int8_t*>(x_q);
  const auto* wq = static_cast<const int8_t*>(w_q);
  const auto* sx = static_cast<const float*>(x_scale);
  const auto* sw = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  auto* ws = static_cast<int32_t*>(workspace);
  auto* cnt = static_cast<int32_t*>(counters);
#define REPRO_INT8_LAUNCH(BM, BN, WM, WN)                                                    \
  return launch<BM, BN, WM, WN>(xq, wq, sx, sw, o, ws, cnt, M, N, K, vec, split_k, k_chunk, \
                                batch, x_shared, s)
  if (block_m == 16 && block_n == 64) REPRO_INT8_LAUNCH(16, 64, 1, 4);
  if (block_m == 16 && block_n == 128) REPRO_INT8_LAUNCH(16, 128, 1, 4);
  if (block_m == 64 && block_n == 128) REPRO_INT8_LAUNCH(64, 128, 2, 4);
  if (block_m == 128 && block_n == 128) REPRO_INT8_LAUNCH(128, 128, 2, 4);
#undef REPRO_INT8_LAUNCH
  return -2;
}
