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
// 0.035 ms at the 989 TFLOP/s of bf16 on the tensor cores, 0.51 ms at the
// 67 TFLOP/s of f32 outside them.
//
// Two kernels, one per input type.
//
// bf16 (flash_attention_bf16_kernel): the FlashAttention-2 shape on
// `mma.sync` tensor cores.  What held the first (PR 12) design back: it
// upcast bf16 to f32 and ran scalar FMAs, so bf16 took as long as f32,
// 3.105 ms at the granite shape against 0.0851 ms for the library's flash
// backend (PERF.md, NVIDIA H100 80GB HBM3, 700 W); with D = 128 it held 64
// floats of q and output per thread (128 registers, a 24-byte stack, two
// blocks an SM).  Now one block of 4 warps owns 64 query rows, 16 per warp.
// The q tile is loaded once into `mma` A fragments (ldmatrix), through the
// shared memory of the second stage before the loop starts.  Key and value
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
// f32 (flash_attention_kernel, unchanged since PR 12): scalar f32 FMAs, one
// block of 256 threads per (batch, head, 64 query rows), four threads per
// query row, each holding a quarter of q and of the running output in
// registers as float4 chunks at d = 16 i + 4 t, so a score is three
// shuffles away; key and value tiles of 32 rows in shared memory.  Per
// tile, as on the TPU: the scores (scaled, masked with -1e30) and their
// maximum first, then m_new = max(m, max_tile), p = exp(s - m_new),
// l = l exp(m - m_new) + sum p, acc = acc exp(m - m_new) + p v.  It stays on
// scalar FMAs because the reference's f32 tolerance (2e-5) rules out TF32.
//
// Common to both: the TPU's sequential KV grid axis becomes the tile loop
// inside the block, and its VMEM scratch (m, l, acc) becomes registers.
// Query head h reads KV head h / (H / KV).  A key tile that starts past the
// block's last query row is skipped (and in the bf16 kernel a warp skips the
// products of a tile that starts past its own last row): every score in it
// would be -1e30 beside a finite running maximum, so its p are exactly 0
// and its correction exactly 1, and skipping changes no bit.  The TPU
// kernel asserts that the tiles divide Sq and Sk; here ragged edges are
// masked instead (query rows past Sq are not stored; key 0 is in the first
// tile of every row, so the running maximum is finite from then on).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "mma_common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kRowsQ = kThreads / 4;  // query rows of a block
constexpr int kTileK = 32;            // key rows of a tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int heads, int kv_heads, int sq, int sk,
                       int causal, float scale) {
  constexpr int NC = D / 16;  // float4 chunks per thread
  __shared__ __align__(16) float k_s[kTileK][D];
  __shared__ __align__(16) float v_s[kTileK][D];
  __shared__ float s_s[kRowsQ][kTileK + 1];

  const int q_tiles = (sq + kRowsQ - 1) / kRowsQ;
  const int qt = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;  // b * heads + h
  const int h = bh % heads, b = bh / heads;
  const int kvh = h / (heads / kv_heads);
  const int row = threadIdx.x / 4, part = threadIdx.x % 4;
  const int q0 = qt * kRowsQ;
  const int qpos = q0 + row;

  const long long q_base = (static_cast<long long>(bh) * sq + qpos) * D;
  const long long kv_base = (static_cast<long long>(b) * kv_heads + kvh) * sk * D;

  float4 qr[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = 16 * c + 4 * part;
    if (qpos < sq) {
      qr[c] = make_float4(to_f32(q[q_base + d]), to_f32(q[q_base + d + 1]),
                          to_f32(q[q_base + d + 2]), to_f32(q[q_base + d + 3]));
    } else {
      qr[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // keys past the block's last query row are masked for every row of it
  const int k_end = causal ? min(sk, q0 + kRowsQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTileK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < sk;
      const long long at = kv_base + static_cast<long long>(k0 + j) * D + d;
      k_s[j][d] = in ? to_f32(k[at]) : 0.f;
      v_s[j][d] = in ? to_f32(v[at]) : 0.f;
    }
    __syncthreads();

    float m_tile = kNegInf;
    for (int j = 0; j < kTileK; ++j) {
      float part_sum = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[j][16 * c + 4 * part]);
        part_sum = fmaf(qr[c].x, kk.x, part_sum);
        part_sum = fmaf(qr[c].y, kk.y, part_sum);
        part_sum = fmaf(qr[c].z, kk.z, part_sum);
        part_sum = fmaf(qr[c].w, kk.w, part_sum);
      }
      part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 1);
      part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 2);
      const int kpos = k0 + j;
      const bool keep = kpos < sk && (!causal || qpos >= kpos);
      const float s = keep ? part_sum * scale : kNegInf;
      m_tile = fmaxf(m_tile, s);
      if (part == 0) s_s[row][j] = s;
    }
    __syncwarp();

    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c].x *= corr; acc[c].y *= corr; acc[c].z *= corr; acc[c].w *= corr;
    }
    for (int j = 0; j < kTileK; ++j) {
      const float p = expf(s_s[row][j] - m_new);
      p_sum += p;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][16 * c + 4 * part]);
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    l = l * corr + p_sum;
    m = m_new;
    __syncthreads();  // the next tile overwrites k_s, v_s and s_s
  }

  if (qpos >= sq) return;
  const float denom = fmaxf(l, 1e-37f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = 16 * c + 4 * part;
    store(out + q_base + d, acc[c].x / denom);
    store(out + q_base + d + 1, acc[c].y / denom);
    store(out + q_base + d + 2, acc[c].z / denom);
    store(out + q_base + d + 3, acc[c].w / denom);
  }
}

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

int launch_f32(const void* q, const void* k, const void* v, void* out, int batch, int heads,
               int kv_heads, int sq, int sk, int d, int causal, float scale, cudaStream_t s) {
  const long long blocks =
      static_cast<long long>(batch) * heads * ((sq + kRowsQ - 1) / kRowsQ);
  if (blocks > 2147483647LL) return -2;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(out);
#define REPRO_FLASH(DIM)                                                                    \
  flash_attention_kernel<float, DIM><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(    \
      qp, kp, vp, op, heads, kv_heads, sq, sk, causal, scale);                              \
  break
  switch (d) {
    case 16: REPRO_FLASH(16);
    case 32: REPRO_FLASH(32);
    case 64: REPRO_FLASH(64);
    case 128: REPRO_FLASH(128);
    default: return -2;
  }
#undef REPRO_FLASH
  return static_cast<int>(cudaGetLastError());
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
// smem_bytes is the wrapper's count of the bf16 kernel's dynamic shared
// memory (`flash_smem_bytes`), 0 for f32.  Returns -1 if that count
// disagrees with the kernel's, -2 for arguments it does not take, else the
// CUDA error of the launch.
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
  if (dtype == 0) {
    if (smem_bytes != 0) return -1;
    return launch_f32(q, k, v, out, batch, heads, kv_heads, sq, sk, d, causal, scale, s);
  }
  if (dtype == 1) return launch_bf16(q, k, v, out, batch, heads, kv_heads, sq, sk, d, causal,
                                     smem_bytes, scale, s);
  return -2;
}
