// Decode attention, one query a cache row, grouped-query (GQA), over the
// live rows of a KV cache only ("flash-decoding"):
//   out[b, h] = softmax_r(q[b, h] . k[b, r, h / g] / sqrt(D)) . v[b, r, h / g]
// over the rows r = 0 .. pos[b] of row b's cache, g = H / KV query heads to
// a KV head.
//
// Replaces no TPU kernel: the JAX package's decode attention is plain jnp
// (models/layers.py:attention_decode), which XLA fuses on the TPU.  The
// port's plain version of it expanded K and V to every query head in f32
// and scored every row of the cache's capacity, masking the dead ones: on
// an H100 the copies of that expansion took 69-86% of the device time of
// each served decode tick (PERF.md).  This kernel was added to read what the
// step needs instead.
//
// Bound on an H100: bytes.  Each live K and V row of a KV head is read once
// in the cache's type (2 * D * 2 bytes in bf16) for all g of its query
// heads; the work is 4 * g flops a row and element, under one flop a byte,
// far below the ridge: CUDA cores and 16-byte loads suffice.
//
// Design.  A block of 4 warps owns one split of `rows` cache rows of one
// (b, group of `hg` query heads of one KV head); the grid is (splits,
// KV * g / hg, B), fixed by the shapes, so one captured CUDA graph serves
// any positions.  pos[b] is read on the device: a block whose split starts
// past it exits at once, and the last live split stops at pos[b].
// - Scores: a row is loaded as 16-byte vectors by the TPR lanes that cover
//   its D values (a warp holds 32 / TPR rows, four loads a lane in flight),
//   widened to f32 in registers and dotted with the group's hg query vectors
//   (held in registers in f32); the lanes' partial dots are summed by
//   shuffles and the scores divided by sqrt(D) go to shared memory.
// - The split's softmax: its maximum per head over those scores, then
//   exp(s - max) in place and their sum, in f32.
// - P.V: the same lanes load V rows and add p * v into f32 accumulators;
//   the row slots of a warp are summed by shuffles, the warps in shared
//   memory.
// - With one live split the block writes out = acc / sum.  With more, each
//   writes (acc, max, sum) to the partials, and the last live block of its
//   (b, group), by an atomic ticket, merges them in split order (the
//   flash-decoding combine: weights exp(max_s - max)) and resets the
//   ticket, so one launch and no second kernel.  The merge reads the splits
//   in a fixed order, so the result does not depend on which block came
//   last.
// No row past pos[b] is read, so what those rows hold (zeros, garbage, NaN)
// never reaches the output; the plain version masks them to weight 0, and
// 0 * NaN is NaN there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "launch.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowMax = 512;  // rows of a split at most: ROW_MAX in kernels/decode_attention.py
constexpr int kUnroll = 4;    // rows a lane has in flight

// The 16 bytes of a vector widened to f32: 8 bf16 or 4 f32 values.
template <bool F32>
__device__ __forceinline__ void widen(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (F32) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ float load_q(const void* q, long long i, int q_f32) {
  if (q_f32) return static_cast<const float*>(q)[i];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
}

__device__ __forceinline__ void store_out(void* out, long long i, float v, int q_f32) {
  if (q_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

// D: the head width; F32: the cache holds f32 (else bf16); G: query heads a
// block holds at most (hg <= G).
template <int D, bool F32, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const void* __restrict__ q, const void* __restrict__ k_cache,
                        const void* __restrict__ v_cache, const void* __restrict__ pos,
                        void* __restrict__ out, float* __restrict__ part_o,
                        float* __restrict__ part_ml, int* __restrict__ tickets, int S, int KV,
                        int H, int hg, int rows, int splits, int q_f32, int pos_i64) {
  constexpr int VEC = F32 ? 4 : 8;                 // values a 16-byte vector
  constexpr int NV = D / VEC;                      // vectors a row
  constexpr int TPR = NV <= 2 ? 2 : NV <= 4 ? 4 : NV <= 8 ? 8 : NV <= 16 ? 16 : 32;
  constexpr int RPW = 32 / TPR;                    // rows a warp holds at once
  constexpr int STEP = kWarps * RPW;               // rows the block holds at once
  static_assert(D % VEC == 0 && NV <= 32, "a row is at most 32 vectors");

  __shared__ float s_p[G][kRowMax];      // scores, then exp(score - max)
  __shared__ float s_o[kWarps][G][D];    // each warp's P.V
  __shared__ float s_red[kWarps][G];
  __shared__ float s_m[G], s_l[G];
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ld = lane % TPR, slot = lane / TPR;    // the lane's vector and row slot
  const bool dvalid = ld < NV;
  const int split = blockIdx.x, b = blockIdx.z;
  const int g = H / KV, groups = g / hg;
  const int kvh = blockIdx.y / groups;
  const int h0 = kvh * g + (blockIdx.y % groups) * hg;
  const long long p = pos_i64 ? static_cast<const long long*>(pos)[b]
                              : static_cast<const int*>(pos)[b];
  const int last = p < 0 ? 0 : (p >= S ? S - 1 : static_cast<int>(p));
  const int live = last / rows + 1;                // splits holding a row <= last
  if (split >= live) return;
  const int start = split * rows;
  const int n = min(rows, last + 1 - start);

  // this lane's D-slice of row `start` of KV head kvh, and the row stride
  const long long row0 = ((static_cast<long long>(b) * S + start) * KV + kvh) * D + ld * VEC;
  const long long stride = static_cast<long long>(KV) * D;
  const uint4* kp = reinterpret_cast<const uint4*>(
      static_cast<const char*>(k_cache) + row0 * (F32 ? 4 : 2));
  const uint4* vp = reinterpret_cast<const uint4*>(
      static_cast<const char*>(v_cache) + row0 * (F32 ? 4 : 2));
  const long long vstride = stride * (F32 ? 4 : 2) / 16;   // in vectors

  // ---- scores ----------------------------------------------------------
  float qr[G][VEC];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      qr[h][i] = (h < hg && dvalid)
                     ? load_q(q, (static_cast<long long>(b) * H + h0 + h) * D + ld * VEC + i, q_f32)
                     : 0.f;
  const float sqrt_d = sqrtf(static_cast<float>(D));
  for (int r0 = warp * RPW; r0 < n; r0 += STEP * kUnroll) {   // uniform over the warp
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * STEP + slot;
      raw[u] = (dvalid && r < n) ? __ldg(kp + r * vstride) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float f[VEC];
      widen<F32>(raw[u], f);
      float dot[G];
#pragma unroll
      for (int h = 0; h < G; ++h) {
        dot[h] = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot[h] = fmaf(qr[h][i], f[i], dot[h]);
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h >= hg) break;
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1) dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], o);
      }
      const int r = r0 + u * STEP + slot;
      if (ld == 0 && r < n) {
#pragma unroll
        for (int h = 0; h < G; ++h)
          if (h < hg) s_p[h][r] = dot[h] / sqrt_d;
      }
    }
  }
  __syncthreads();

  // ---- the split's softmax: max, exp, sum ---------------------------------
  float red[G];
#pragma unroll
  for (int h = 0; h < G; ++h) red[h] = -CUDART_INF_F;
  for (int r = tid; r < n; r += kThreads)
#pragma unroll
    for (int h = 0; h < G; ++h)
      if (h < hg) red[h] = fmaxf(red[h], s_p[h][r]);
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      red[h] = fmaxf(red[h], __shfl_xor_sync(0xffffffffu, red[h], o));
  if (lane == 0)
#pragma unroll
    for (int h = 0; h < G; ++h) s_red[warp][h] = red[h];
  __syncthreads();
  float m[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = s_red[0][h];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m[h] = fmaxf(m[h], s_red[w][h]);
    red[h] = 0.f;
  }
  for (int r = tid; r < n; r += kThreads)
#pragma unroll
    for (int h = 0; h < G; ++h)
      if (h < hg) {
        const float e = expf(s_p[h][r] - m[h]);
        s_p[h][r] = e;
        red[h] += e;
      }
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) red[h] += __shfl_xor_sync(0xffffffffu, red[h], o);
  __syncthreads();  // every thread has read s_red's maxima
  if (lane == 0)
#pragma unroll
    for (int h = 0; h < G; ++h) s_red[warp][h] = red[h];
  __syncthreads();
  if (tid == 0)
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) l += s_red[w][h];
      s_m[h] = m[h];
      s_l[h] = l;
    }

  // ---- P.V ---------------------------------------------------------------
  float acc[G][VEC];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[h][i] = 0.f;
  for (int r0 = warp * RPW; r0 < n; r0 += STEP * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * STEP + slot;
      raw[u] = (dvalid && r < n) ? __ldg(vp + r * vstride) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * STEP + slot;
      if (r >= n) continue;
      float f[VEC];
      widen<F32>(raw[u], f);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h >= hg) break;
        const float w = s_p[h][r];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[h][i] = fmaf(w, f[i], acc[h][i]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1) acc[h][i] += __shfl_xor_sync(0xffffffffu, acc[h][i], o);
  if (slot == 0 && dvalid)
#pragma unroll
    for (int h = 0; h < G; ++h)
      if (h < hg)
#pragma unroll
        for (int i = 0; i < VEC; ++i) s_o[warp][h][ld * VEC + i] = acc[h][i];
  __syncthreads();

  const long long head0 = static_cast<long long>(b) * H + h0;   // (b, h0) of out: (B, H, D)
  for (int idx = tid; idx < hg * D; idx += kThreads) {
    const int h = idx / D, d = idx - h * D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += s_o[w][h][d];
    if (live == 1)
      store_out(out, (head0 + h) * D + d, o / s_l[h], q_f32);
    else
      part_o[((head0 + h) * splits + split) * D + d] = o;
  }
  if (live == 1) return;
  if (tid < hg) {
    float* ml = part_ml + ((head0 + tid) * splits + split) * 2;
    ml[0] = s_m[tid];
    ml[1] = s_l[tid];
  }

  // ---- the last live block of (b, group) merges the splits ---------------
  __threadfence();
  __syncthreads();
  int* ticket = tickets + static_cast<long long>(b) * gridDim.y + blockIdx.y;
  if (tid == 0) s_last = atomicAdd(ticket, 1) == live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int idx = tid; idx < hg * D; idx += kThreads) {
    const int h = idx / D, d = idx - h * D;
    const float* ml = part_ml + (head0 + h) * splits * 2;
    const float* po = part_o + (head0 + h) * splits * D + d;
    float mx = -CUDART_INF_F;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, __ldcg(ml + 2 * s));
    float l = 0.f, o = 0.f;
    for (int s = 0; s < live; ++s) {
      const float w = expf(__ldcg(ml + 2 * s) - mx);
      l = fmaf(__ldcg(ml + 2 * s + 1), w, l);
      o = fmaf(__ldcg(po + static_cast<long long>(s) * D), w, o);
    }
    store_out(out, (head0 + h) * D + d, o / l, q_f32);
  }
  if (tid == 0) *ticket = 0;
}

template <int D, bool F32, int G>
int launch(const long long* a, dim3 grid, cudaStream_t s) {
  decode_attention_kernel<D, F32, G><<<grid, kThreads, 0, s>>>(
      arg_ptr<const void>(a[0]), arg_ptr<const void>(a[1]), arg_ptr<const void>(a[2]),
      arg_ptr<const void>(a[3]), arg_ptr<void>(a[4]), arg_ptr<float>(a[5]),
      arg_ptr<float>(a[6]), arg_ptr<int>(a[7]), static_cast<int>(a[9]),
      static_cast<int>(a[10]), static_cast<int>(a[11]), static_cast<int>(a[13]),
      static_cast<int>(a[14]), static_cast<int>(a[15]), static_cast<int>(a[16]),
      static_cast<int>(a[18]));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const long long* a, dim3 grid, int kv_f32, int hg, cudaStream_t s) {
  if (kv_f32) return hg <= 4 ? launch<D, true, 4>(a, grid, s) : launch<D, true, 8>(a, grid, s);
  return hg <= 4 ? launch<D, false, 4>(a, grid, s) : launch<D, false, 8>(a, grid, s);
}

}  // namespace
}  // namespace repro

// a = {q, k_cache, v_cache, pos, out, part_o, part_ml, tickets, B, S, KV, H, D,
// hg, rows, splits, q_f32, kv_f32, pos_i64, stream}.
// q: (B, H, D) and out: (B, H, D), bf16 (q_f32 = 0) or f32; k_cache and
// v_cache: (B, S, KV, D), bf16 (kv_f32 = 0) or f32, contiguous, 16-byte
// aligned; pos: (B,) int32 (pos_i64 = 0) or int64, each clamped to [0, S).
// D one of 16, 64, 112, 128; H a multiple of KV; hg, the query heads a
// block takes, at most 8 and dividing H / KV; S cut into `splits` splits of
// `rows` <= 512 rows, the last one non-empty.  With splits > 1: part_o (B,
// H, splits, D) and part_ml (B, H, splits, 2) f32, and tickets, B * KV *
// (H / KV / hg) int32, all zero, which the kernel leaves zero.  Returns -2
// for arguments it does not take, else the CUDA error of the launch.
extern "C" int repro_decode_attention(const long long* a, int count) {
  using namespace repro;
  if (count != 20) return kBadArgCount;
  const long long B = a[8], S = a[9], KV = a[10], H = a[11], D = a[12], hg = a[13];
  const long long rows = a[14], splits = a[15], kv_f32 = a[17];
  cudaStream_t s = arg_stream(a[19]);
  if (B < 1 || B > 65535 || S < 1 || KV < 1 || H < KV || H % KV) return -2;
  if (hg < 1 || hg > 8 || (H / KV) % hg || KV * (H / KV / hg) > 65535) return -2;
  if (rows < 1 || rows > kRowMax || splits < 1 || splits * rows < S || (splits - 1) * rows >= S)
    return -2;
  if (splits > 1 && (a[5] == 0 || a[6] == 0 || a[7] == 0)) return -2;
  if ((a[1] | a[2]) & 15) return -2;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(KV * (H / KV / hg)),
                  static_cast<unsigned>(B));
  const int h = static_cast<int>(hg), f = static_cast<int>(kv_f32);
  if (D == 16) return launch_d<16>(a, grid, f, h, s);
  if (D == 64) return launch_d<64>(a, grid, f, h, s);
  if (D == 112) return launch_d<112>(a, grid, f, h, s);
  if (D == 128) return launch_d<128>(a, grid, f, h, s);
  return -2;
}
