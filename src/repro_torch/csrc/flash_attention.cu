// Blocked online-softmax ("flash") attention with GQA and an optional
// causal mask: out = softmax(q k^T / sqrt(D)) v, one query row at a time,
// without ever holding a whole score row.
//
// Replaces: the Pallas TPU kernel `_kernel` launched by
// `_flash_attention_call` in the JAX package's kernels/flash_attention.py
// (public `flash_attention`, reached through kernels/ops.py).
//
// Bound on an H100: operations.  4*B*H*Sq*Sk*D flops (two products), halved
// by a causal mask; at (B=1, H=32, S=2048, D=128) causal that is 34 GFLOP,
// 0.5 ms at the 67 TFLOP/s of f32 outside the tensor cores, which is what
// this first kernel uses (scalar f32 FMAs; the tensor cores come later).
//
// Design: one block of 256 threads per (batch, head, 64 query rows).  Four
// neighbouring threads share a query row, each holding a quarter of q and of
// the running output in registers, as float4 chunks at d = 16 i + 4 t, so a
// score is three shuffles away.  Keys and values come through shared memory
// in tiles of 32 rows, upcast to f32 on the way in.  Per tile, as on the TPU:
// the scores (scaled, masked with -1e30) and their maximum first, then
// m_new = max(m, max_tile), p = exp(s - m_new), l = l exp(m - m_new) + sum p,
// acc = acc exp(m - m_new) + p v; at the end acc / max(l, 1e-37).  The TPU's
// sequential KV grid axis becomes the tile loop inside the block, and its
// VMEM scratch (m, l, acc) becomes registers.  Query head h reads KV head
// h / (H / KV).  The causal mask is top-left aligned (query i sees keys
// 0..i).  A key tile that starts past the block's last query row is skipped:
// every score in it would be -1e30 beside a finite running maximum, so its
// p are exactly 0 and its correction exactly 1, and skipping changes no bit.
// The TPU kernel asserts that the tiles divide Sq and Sk; here ragged edges
// are masked instead (query rows past Sq are not stored, keys past Sk score
// -1e30 like masked ones; key 0 is in the first tile of every row, so they
// add nothing).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kRowsQ = kThreads / 4;  // query rows of a block
constexpr int kTileK = 32;            // key rows of a tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int heads,
           int kv_heads, int sq, int sk, int d, int causal, float scale, cudaStream_t s) {
  const long long blocks =
      static_cast<long long>(batch) * heads * ((sq + kRowsQ - 1) / kRowsQ);
  if (blocks > 2147483647LL) return -2;
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  auto* op = static_cast<T*>(out);
#define REPRO_FLASH(DIM)                                                                    \
  flash_attention_kernel<T, DIM><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(        \
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

}  // namespace
}  // namespace repro

// q: (B, H, Sq, D); k, v: (B, KV, Sk, D); out: (B, H, Sq, D); contiguous,
// all of one type: dtype 0 = f32, 1 = bf16.  D in {16, 32, 64, 128}; KV
// divides H.  scale is 1/sqrt(D).  Returns -2 for arguments it does not
// take, else cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int batch, int heads, int kv_heads, int sq, int sk, int d,
                                     int causal, int dtype, float scale, void* stream) {
  using namespace repro;
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || sq < 1 || sk < 1) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, batch, heads, kv_heads, sq, sk, d, causal,
                                       scale, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, out, batch, heads, kv_heads, sq, sk, d,
                                               causal, scale, s);
  return -2;
}
