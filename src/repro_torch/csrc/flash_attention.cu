// Blocked online-softmax ("flash") attention with GQA and an optional
// causal mask: out = softmax(q k^T / sqrt(D)) v, without ever holding a
// whole score row.
//
// Replaces: the Pallas TPU kernel `_kernel` launched by
// `_flash_attention_call` in the JAX package's kernels/flash_attention.py
// (public `flash_attention`, reached through kernels/ops.py).
//
// Bound on an H100: operations.  4*B*H*Sq*Sk*D flops (two products), halved
// by a causal mask; at (B=1, H=32, S=2048, D=128) causal that is 34 GFLOP:
// 0.035 ms at the 989 TFLOP/s of bf16 on the tensor cores; in f32, 0.51 ms at
// the 67 TFLOP/s of the CUDA cores, or 0.21 ms for the three TF32 products of
// the split below at 495 TFLOP/s.
//
// Two kernels, one per input type, both in the FlashAttention-2 shape on
// `mma.sync` tensor cores.
//
// bf16 (flash_attention_bf16_kernel): m16n8k16 bf16 products.  What held
// the first design back: it upcast bf16 to f32 and ran scalar FMAs, so bf16
// took as long as f32, 3.105 ms at the granite shape against 0.0851 ms for
// the library's flash backend (PERF.md, NVIDIA H100 80GB HBM3, 700 W); with
// D = 128 it held 64 floats of q and output per thread (128 registers, a
// 24-byte stack, two blocks an SM).  Now one block of 4 warps owns 64 query
// rows, 16 per warp.  The q tile is loaded once into `mma` A fragments
// (ldmatrix), through the shared memory of the second stage before the loop
// starts.  Key and value
// tiles of 64 rows arrive through a two-stage ring of 16-byte cp.async
// copies in dynamic shared memory (70 KB at D = 128, so three blocks share
// an SM, 168 registers a thread at most), each row padded by 16 bytes so
// that the 8 rows an ldmatrix reads fall in 8 distinct bank groups; one
// barrier per tile.
// S = Q K^T runs as m16n8k16 bf16 products with f32 sums; K is stored
// (Sk, D) with d contiguous, which is already the "col" B operand.  The
// scores are scaled, masked (-1e30 causal, top-left aligned; -inf for key
// rows past Sk) only in tiles that cross the diagonal or the ragged end, and
// go through the online softmax in registers: each thread holds two rows'
// scores, so a row's maximum is two shuffles inside a quad of lanes; the row
// sum l stays a per-thread partial until the end; exp(x) is computed as
// exp2f(x log2 e).  P goes from the S
// accumulators straight into A fragments, rounded to bf16 (as the library's
// flash backend does; the reference keeps p in f32, so this is a deliberate
// difference, mirrored by the plain version), and P V reads V through
// ldmatrix.trans.  At the end acc / max(l, 1e-37).  Query tiles are issued
// last tile first, so that the longest causal rows start first and the
// short ones fill the tail.
//
// f32 (flash_attention_kernel): split TF32 ("3xTF32") on `mma.sync`
// m16n8k8.  What held the first design back: scalar FMAs, four threads a
// query row, one shared-memory load for every four FMAs and every score
// through shared memory, 3.0 ms at the granite shape, 17% of the CUDA cores'
// bound (PERF.md).  TF32 alone keeps 10 mantissa bits, too few for the
// reference's f32 tolerance (2e-5), so each operand a is split into
// hi = tf32_rna(a) and lo = tf32_rna(a - hi) (nearest, ties away), and each
// product is summed as lo*hi + hi*lo + hi*hi, small terms first, in TF32
// products with f32 accumulators; lo*lo, about 2^-22 of the product, is
// dropped.  Both products are split, P too: like the reference, and unlike
// the bf16 kernel, this one keeps p in f32.  The skeleton is the bf16
// kernel's (4 warps of 16 query rows, the online softmax in registers, the
// longest causal rows first, a warp's products skipped past its last row).
// What differs:
// - A TF32 fragment element is a 32-bit word and no 32-bit ldmatrix.trans
//   exists, so both products read their operands with plain shared loads in
//   a permuted order.  Along a product's depth, fragment column t stands for
//   element 2t and column t + 4 for element 2t + 1 of each 8 (a sum does not
//   care about the order of its terms): Q's and K's pairs are one 8-byte
//   load, P's come straight from the S accumulators, which hold keys 2t and
//   2t + 1, and V's B fragment is rows 2t and 2t + 1 of the tile at column g.
// - Q's split fragments would take 128 registers a thread at D = 128, so the
//   q tile stays in shared memory as f32 and is split again at every tile.
//   K and V tiles of 32 keys arrive as f32 through a two-stage cp.async ring.
//   Q and K rows are padded to a pitch of 8 mod 16 floats and V rows to
//   4 mod 16, which puts a half warp's 8-byte Q/K loads and a warp's V loads
//   in distinct banks.  101 KB at D = 128: two blocks an SM.
// - Scores are masked at -1e30, causal (top-left) and for key rows past Sk,
//   and exp is expf, as in the first design and the reference.
//
// Common to both: the TPU's sequential KV grid axis becomes the tile loop
// inside the block, and its VMEM scratch (m, l, acc) becomes registers.
// Query head h reads KV head h / (H / KV).  A key tile that starts past the
// block's last query row is not loaded, and a warp skips the products of a
// tile that starts past its own last row: every score in it would be -1e30
// beside a finite running maximum, so its p are exactly 0 and its correction
// exactly 1, and skipping changes no bit.  The TPU kernel asserts that the
// tiles divide Sq and Sk; here ragged edges are masked instead (query rows
// past Sq are not stored; key 0 is in the first tile of every row, so the
// running maximum is finite from then on).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "mma_common.cuh"

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRowsQ = 16 * kMmaWarps;  // query rows of a block
constexpr int kMmaTileK = 64;              // key rows of a tile; TILE_K_BF16 in Python
constexpr int kMmaStages = 2;              // K/V tiles in flight
constexpr int kRowPad = 8;                 // bf16 elements of padding per shared row

// Bytes of dynamic shared memory: `kMmaStages` K and V tiles, rows of
// D + kRowPad bf16; the q tile passes through stage 1's K tile before the
// loop starts.  `flash_smem_bytes` in kernels/flash_attention.py.
constexpr int mma_smem_bytes(int d) {
  return 2 * kMmaStages * kMmaTileK * (d + kRowPad) * 2;
}
static_assert(kMmaRowsQ <= kMmaTileK && kMmaStages >= 2, "the q tile borrows stage 1");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 3)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                            int batch_heads, int heads, int kv_heads, int sq, int sk, int causal,
                            float scale) {
  constexpr int P = D + kRowPad;   // shared row pitch, in elements
  constexpr int KD = D / 16;       // k-steps of Q K^T
  constexpr int ND = D / 8;        // n-blocks of the output
  constexpr int NK = kMmaTileK / 8;  // n-blocks of a score tile
  constexpr int CHUNKS = D / 8;    // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // stage s: K, then V
  __nv_bfloat16* q_s = kv_s + 2 * kMmaTileK * P;                       // stage 1's K tile

  const int q_tiles = (sq + kMmaRowsQ - 1) / kMmaRowsQ;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x / batch_heads);  // long rows first
  const int bh = static_cast<int>(blockIdx.x % batch_heads);                // b * heads + h
  const int h = bh % heads, b = bh / heads;
  const int kvh = h / (heads / kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kMmaRowsQ;
  const int qw0 = q0 + 16 * warp;  // the warp's first query row

  const __nv_bfloat16* q_bh = q + static_cast<long long>(bh) * sq * D;
  const __nv_bfloat16* k_bh = k + (static_cast<long long>(b) * kv_heads + kvh) * sk * D;
  const __nv_bfloat16* v_bh = v + (static_cast<long long>(b) * kv_heads + kvh) * sk * D;

  // rows [row0, row0 + n) of a (rows, D) matrix into shared rows of pitch P;
  // rows past `rows` are filled with zeros
  auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int rows, int n) {
    for (int e = threadIdx.x; e < n * CHUNKS; e += kMmaThreads) {
      const int r = e / CHUNKS, c = e % CHUNKS;
      const bool in = row0 + r < rows;
      const __nv_bfloat16* from = in ? src + static_cast<long long>(row0 + r) * D + 8 * c : src;
      mma::cp_async16(dst + r * P + 8 * c, from, in ? 16 : 0);
    }
  };
  auto load_kv = [&](int tile, int stage) {
    __nv_bfloat16* ks = kv_s + stage * 2 * kMmaTileK * P;
    load_rows(ks, k_bh, tile * kMmaTileK, sk, kMmaTileK);
    load_rows(ks + kMmaTileK * P, v_bh, tile * kMmaTileK, sk, kMmaTileK);
  };

  // keys past the block's last query row are masked for every row of it
  const int k_end = causal ? min(sk, q0 + kMmaRowsQ) : sk;
  const int n_tiles = (k_end + kMmaTileK - 1) / kMmaTileK;

  load_rows(q_s, q_bh, q0, sq, kMmaRowsQ);
  load_kv(0, 0);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    mma::ldmatrix_x4(qf[kd], q_s + (16 * warp + (lane & 15)) * P + 16 * kd + 8 * (lane >> 4));
  __syncthreads();  // stage 1 is free for tile 1

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf}, l_row[2] = {0.f, 0.f};  // rows g and g + 8

  // Tile j + 1 is copied while tile j is multiplied; one barrier per tile
  // both publishes tile j + 1 and frees tile j's stage for tile j + 2.
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv(j + 1, (j + 1) % kMmaStages);
    mma::cp_async_commit();
    const int k0 = j * kMmaTileK;
    if (!(causal && k0 > qw0 + 15)) {  // else every score of the warp's rows is masked
      const __nv_bfloat16* ks = kv_s + (j % kMmaStages) * 2 * kMmaTileK * P;
      const __nv_bfloat16* vs = ks + kMmaTileK * P;
      float s[NK][4];
#pragma unroll
      for (int i = 0; i < NK; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int nb = 0; nb < NK; nb += 2) {
          uint32_t bk[4];  // keys 8 nb .. 8 nb + 15, d 16 kd .. 16 kd + 15
          mma::ldmatrix_x4(bk, ks + (8 * nb + (lane & 7) + 8 * (lane >> 4)) * P + 16 * kd +
                                   8 * ((lane >> 3) & 1));
          mma::mma_bf16_16816(s[nb], qf[kd], bk[0], bk[1]);
          mma::mma_bf16_16816(s[nb + 1], qf[kd], bk[2], bk[3]);
        }
      }
      const bool edge = k0 + kMmaTileK > sk || (causal && k0 + kMmaTileK - 1 > qw0);
#pragma unroll
      for (int nb = 0; nb < NK; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[nb][i] * scale;
          if (edge) {
            const int key = k0 + 8 * nb + 2 * t + (i & 1);
            const int row = qw0 + g + 8 * (i >> 1);
            if (key >= sk) x = __int_as_float(0xff800000);  // -inf
            else if (causal && key > row) x = kNegInf;
          }
          s[nb][i] = x;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = kNegInf;
#pragma unroll
        for (int nb = 0; nb < NK; ++nb) mt = fmaxf(mt, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m_row[r], mt);
        const float corr = exp2f((m_row[r] - m_new) * kLog2e);  // exp(x) = 2^(x log2 e)
        m_row[r] = m_new;
        float p_sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < NK; ++nb) {
          s[nb][2 * r] = exp2f((s[nb][2 * r] - m_new) * kLog2e);
          s[nb][2 * r + 1] = exp2f((s[nb][2 * r + 1] - m_new) * kLog2e);
          p_sum += s[nb][2 * r] + s[nb][2 * r + 1];
        }
        l_row[r] = l_row[r] * corr + p_sum;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          o[nd][2 * r] *= corr;
          o[nd][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {  // keys 16 kk .. 16 kk + 15
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t bv[4];  // keys 16 kk .. + 15, d 8 nd .. 8 nd + 15, transposed
          mma::ldmatrix_x4_trans(bv, vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * P +
                                         8 * nd + 8 * (lane >> 4));
          mma::mma_bf16_16816(o[nd], pa, bv[0], bv[1]);
          mma::mma_bf16_16816(o[nd + 1], pa, bv[2], bv[3]);
        }
      }
    }
    mma::cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = qw0 + g + 8 * r;
    if (row >= sq) continue;
    const float denom = fmaxf(l, 1e-37f);
    __nv_bfloat16* dst = out + (static_cast<long long>(bh) * sq + row) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(o[nd][2 * r] / denom, o[nd][2 * r + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nd) = pair;
    }
  }
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores: split TF32
// ---------------------------------------------------------------------------
constexpr int kF32Warps = 4;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32RowsQ = 16 * kF32Warps;  // query rows of a block
constexpr int kF32TileK = 32;              // key rows of a tile; TILE_K in Python
constexpr int kF32Stages = 2;              // K/V tiles in flight; STAGES_F32
constexpr int kPadQK = 8;                  // floats of padding per Q and K row; ROW_PAD_QK_F32
constexpr int kPadV = 4;                   // floats of padding per V row; ROW_PAD_V_F32

// Bytes of dynamic shared memory: the q tile, then `kF32Stages` K and V
// tiles, all f32.  `flash_smem_bytes` in kernels/flash_attention.py.
constexpr int f32_smem_bytes(int d) {
  return 4 * (kF32RowsQ * (d + kPadQK) + kF32Stages * kF32TileK * ((d + kPadQK) + (d + kPadV)));
}

// x = hi + lo + (what lo's rounding drops), hi and lo rounded to TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = mma::tf32_rna(x);
  lo = mma::tf32_rna(x - __uint_as_float(hi));
}

// d += a b in three TF32 products, small terms first: a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], uint32_t b_hi0,
                                           uint32_t b_hi1, uint32_t b_lo0, uint32_t b_lo1) {
  mma::mma_tf32_1688(d, a_lo, b_hi0, b_hi1);
  mma::mma_tf32_1688(d, a_hi, b_lo0, b_lo1);
  mma::mma_tf32_1688(d, a_hi, b_hi0, b_hi1);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int batch_heads,
                       int heads, int kv_heads, int sq, int sk, int causal, float scale) {
  constexpr int PQ = D + kPadQK;  // shared row pitch of Q and K, in floats
  constexpr int PV = D + kPadV;   // of V
  constexpr int KD = D / 8;       // k-steps of Q K^T
  constexpr int ND = D / 8;       // n-blocks of the output
  constexpr int NK = kF32TileK / 8;  // n-blocks of a score tile, k-steps of P V
  constexpr int CHUNKS = D / 4;   // 16-byte chunks of a row
  constexpr int STAGE = kF32TileK * (PQ + PV);  // floats of one K and V stage
  static_assert(PQ % 16 == 8 && PV % 16 == 4, "the bank layout of the shared loads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* kv_s = q_s + kF32RowsQ * PQ;  // stage s: K (pitch PQ), then V (pitch PV)

  const int q_tiles = (sq + kF32RowsQ - 1) / kF32RowsQ;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x / batch_heads);  // long rows first
  const int bh = static_cast<int>(blockIdx.x % batch_heads);                // b * heads + h
  const int h = bh % heads, b = bh / heads;
  const int kvh = h / (heads / kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kF32RowsQ;
  const int qw0 = q0 + 16 * warp;  // the warp's first query row

  const float* q_bh = q + static_cast<long long>(bh) * sq * D;
  const float* k_bh = k + (static_cast<long long>(b) * kv_heads + kvh) * sk * D;
  const float* v_bh = v + (static_cast<long long>(b) * kv_heads + kvh) * sk * D;

  // rows [row0, row0 + n) of a (rows, D) matrix into shared rows of pitch
  // `pitch`; rows past `rows` are filled with zeros
  auto load_rows = [&](float* dst, int pitch, const float* src, int row0, int rows, int n) {
    for (int e = threadIdx.x; e < n * CHUNKS; e += kF32Threads) {
      const int r = e / CHUNKS, c = e % CHUNKS;
      const bool in = row0 + r < rows;
      const float* from = in ? src + static_cast<long long>(row0 + r) * D + 4 * c : src;
      mma::cp_async16(dst + r * pitch + 4 * c, from, in ? 16 : 0);
    }
  };
  auto load_kv = [&](int tile, int stage) {
    float* ks = kv_s + stage * STAGE;
    load_rows(ks, PQ, k_bh, tile * kF32TileK, sk, kF32TileK);
    load_rows(ks + kF32TileK * PQ, PV, v_bh, tile * kF32TileK, sk, kF32TileK);
  };

  // keys past the block's last query row are masked for every row of it
  const int k_end = causal ? min(sk, q0 + kF32RowsQ) : sk;
  const int n_tiles = (k_end + kF32TileK - 1) / kF32TileK;

  load_rows(q_s, PQ, q_bh, q0, sq, kF32RowsQ);
  load_kv(0, 0);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf}, l_row[2] = {0.f, 0.f};  // rows g and g + 8
  const float* qw = q_s + (16 * warp + g) * PQ + 2 * t;  // row g, d 2t; row g + 8 is + 8 PQ

  // Tile j + 1 is copied while tile j is multiplied; one barrier per tile
  // both publishes tile j + 1 and frees tile j's stage for tile j + 2.
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv(j + 1, (j + 1) % kF32Stages);
    mma::cp_async_commit();
    const int k0 = j * kF32TileK;
    if (!(causal && k0 > qw0 + 15)) {  // else every score of the warp's rows is masked
      const float* ks = kv_s + (j % kF32Stages) * STAGE;
      const float* vs = ks + kF32TileK * PQ;
      float s[NK][4];
#pragma unroll
      for (int i = 0; i < NK; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        // column t of the k-step is d = 8 kd + 2t, column t + 4 is d = 8 kd + 2t + 1
        const float2 qg = *reinterpret_cast<const float2*>(qw + 8 * kd);
        const float2 qg8 = *reinterpret_cast<const float2*>(qw + 8 * PQ + 8 * kd);
        uint32_t a_hi[4], a_lo[4];
        split_tf32(qg.x, a_hi[0], a_lo[0]);
        split_tf32(qg8.x, a_hi[1], a_lo[1]);
        split_tf32(qg.y, a_hi[2], a_lo[2]);
        split_tf32(qg8.y, a_hi[3], a_lo[3]);
#pragma unroll
        for (int nb = 0; nb < NK; ++nb) {  // keys 8 nb .. 8 nb + 7; lane's B column: key 8 nb + g
          const float2 kf =
              *reinterpret_cast<const float2*>(ks + (8 * nb + g) * PQ + 8 * kd + 2 * t);
          uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
          split_tf32(kf.x, b_hi0, b_lo0);
          split_tf32(kf.y, b_hi1, b_lo1);
          mma_3xtf32(s[nb], a_hi, a_lo, b_hi0, b_hi1, b_lo0, b_lo1);
        }
      }
      const bool edge = k0 + kF32TileK > sk || (causal && k0 + kF32TileK - 1 > qw0);
#pragma unroll
      for (int nb = 0; nb < NK; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[nb][i] * scale;
          if (edge) {
            const int key = k0 + 8 * nb + 2 * t + (i & 1);
            const int row = qw0 + g + 8 * (i >> 1);
            if (key >= sk || (causal && key > row)) x = kNegInf;
          }
          s[nb][i] = x;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = kNegInf;
#pragma unroll
        for (int nb = 0; nb < NK; ++nb) mt = fmaxf(mt, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m_row[r], mt);
        const float corr = expf(m_row[r] - m_new);
        m_row[r] = m_new;
        float p_sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < NK; ++nb) {
          s[nb][2 * r] = expf(s[nb][2 * r] - m_new);
          s[nb][2 * r + 1] = expf(s[nb][2 * r + 1] - m_new);
          p_sum += s[nb][2 * r] + s[nb][2 * r + 1];
        }
        l_row[r] = l_row[r] * corr + p_sum;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          o[nd][2 * r] *= corr;
          o[nd][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {  // keys 8 kk .. 8 kk + 7
        // column t of the k-step is key 8 kk + 2t, column t + 4 is key 8 kk + 2t + 1
        uint32_t a_hi[4], a_lo[4];
        split_tf32(s[kk][0], a_hi[0], a_lo[0]);
        split_tf32(s[kk][2], a_hi[1], a_lo[1]);
        split_tf32(s[kk][1], a_hi[2], a_lo[2]);
        split_tf32(s[kk][3], a_hi[3], a_lo[3]);
        const float* vr = vs + (8 * kk + 2 * t) * PV + g;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {  // d 8 nd .. 8 nd + 7; lane's B column: d 8 nd + g
          uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
          split_tf32(vr[8 * nd], b_hi0, b_lo0);
          split_tf32(vr[PV + 8 * nd], b_hi1, b_lo1);
          mma_3xtf32(o[nd], a_hi, a_lo, b_hi0, b_hi1, b_lo0, b_lo1);
        }
      }
    }
    mma::cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = qw0 + g + 8 * r;
    if (row >= sq) continue;
    const float denom = fmaxf(l, 1e-37f);
    float* dst = out + (static_cast<long long>(bh) * sq + row) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<float2*>(dst + 8 * nd) =
          make_float2(o[nd][2 * r] / denom, o[nd][2 * r + 1] / denom);
  }
}

template <int D>
int launch_f32_dim(const void* q, const void* k, const void* v, void* out, int batch, int heads,
                   int kv_heads, int sq, int sk, int causal, float scale, cudaStream_t s) {
  static int smem_set[kMaxDevices] = {};
  constexpr int smem = f32_smem_bytes(D);
  const int rc = allow_smem(flash_attention_kernel<D>, smem, smem_set);
  if (rc != 0) return rc;
  const long long bh = static_cast<long long>(batch) * heads;
  const long long blocks = bh * ((sq + kF32RowsQ - 1) / kF32RowsQ);
  if (blocks > 2147483647LL) return -2;
  flash_attention_kernel<D><<<static_cast<unsigned>(blocks), kF32Threads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<int>(bh), heads, kv_heads, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int batch, int heads,
               int kv_heads, int sq, int sk, int d, int causal, int smem_bytes, float scale,
               cudaStream_t s) {
  if (d != 16 && d != 32 && d != 64 && d != 128) return -2;
  if (smem_bytes != f32_smem_bytes(d)) return -1;
  switch (d) {
    case 16: return launch_f32_dim<16>(q, k, v, out, batch, heads, kv_heads, sq, sk, causal,
                                       scale, s);
    case 32: return launch_f32_dim<32>(q, k, v, out, batch, heads, kv_heads, sq, sk, causal,
                                       scale, s);
    case 64: return launch_f32_dim<64>(q, k, v, out, batch, heads, kv_heads, sq, sk, causal,
                                       scale, s);
    default: return launch_f32_dim<128>(q, k, v, out, batch, heads, kv_heads, sq, sk, causal,
                                        scale, s);
  }
}

template <int D>
int launch_bf16_dim(const void* q, const void* k, const void* v, void* out, int batch, int heads,
                    int kv_heads, int sq, int sk, int causal, float scale, cudaStream_t s) {
  static int smem_set[kMaxDevices] = {};
  constexpr int smem = mma_smem_bytes(D);
  const int rc = allow_smem(flash_attention_bf16_kernel<D>, smem, smem_set);
  if (rc != 0) return rc;
  const long long bh = static_cast<long long>(batch) * heads;
  const long long blocks = bh * ((sq + kMmaRowsQ - 1) / kMmaRowsQ);
  if (blocks > 2147483647LL) return -2;
  flash_attention_bf16_kernel<D><<<static_cast<unsigned>(blocks), kMmaThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<int>(bh), heads, kv_heads, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int batch, int heads,
                int kv_heads, int sq, int sk, int d, int causal, int smem_bytes, float scale,
                cudaStream_t s) {
  if (d != 16 && d != 32 && d != 64 && d != 128) return -2;
  if (smem_bytes != mma_smem_bytes(d)) return -1;
  switch (d) {
    case 16: return launch_bf16_dim<16>(q, k, v, out, batch, heads, kv_heads, sq, sk, causal,
                                        scale, s);
    case 32: return launch_bf16_dim<32>(q, k, v, out, batch, heads, kv_heads, sq, sk, causal,
                                        scale, s);
    case 64: return launch_bf16_dim<64>(q, k, v, out, batch, heads, kv_heads, sq, sk, causal,
                                        scale, s);
    default: return launch_bf16_dim<128>(q, k, v, out, batch, heads, kv_heads, sq, sk, causal,
                                         scale, s);
  }
}

}  // namespace
}  // namespace repro

// a = {q, k, v, out, batch, heads, kv_heads, sq, sk, d, causal, dtype,
// smem_bytes, stream}.  q: (B, H, Sq, D); k, v: (B, KV, Sk, D); out:
// (B, H, Sq, D); contiguous, all of one type: dtype 0 = f32, 1 = bf16
// (16-byte aligned base pointers).  D in {16, 32, 64, 128}; KV divides H.
// The scores are scaled by 1/sqrt(D), rounded once from double to float.
// smem_bytes is the wrapper's count of the kernel's dynamic shared memory
// (`flash_smem_bytes`, by type).  Returns -1 if that count disagrees with
// the kernel's, -2 for arguments it does not take, else the CUDA error of
// the launch.
extern "C" int repro_flash_attention(const long long* a, int count) {
  using namespace repro;
  if (count != 14) return kBadArgCount;
  const void* q = arg_ptr<const void>(a[0]);
  const void* k = arg_ptr<const void>(a[1]);
  const void* v = arg_ptr<const void>(a[2]);
  void* out = arg_ptr<void>(a[3]);
  const int batch = static_cast<int>(a[4]), heads = static_cast<int>(a[5]);
  const int kv_heads = static_cast<int>(a[6]), sq = static_cast<int>(a[7]);
  const int sk = static_cast<int>(a[8]), d = static_cast<int>(a[9]);
  const int causal = static_cast<int>(a[10]), dtype = static_cast<int>(a[11]);
  const int smem_bytes = static_cast<int>(a[12]);
  cudaStream_t s = arg_stream(a[13]);
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || sq < 1 || sk < 1 || d < 1)
    return -2;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  if (dtype == 0) return launch_f32(q, k, v, out, batch, heads, kv_heads, sq, sk, d, causal,
                                    smem_bytes, scale, s);
  if (dtype == 1) return launch_bf16(q, k, v, out, batch, heads, kv_heads, sq, sk, d, causal,
                                     smem_bytes, scale, s);
  return -2;
}
