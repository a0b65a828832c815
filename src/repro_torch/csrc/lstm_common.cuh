// Building blocks of the LSTM kernels: the block paths of lstm_seq.cu run
// the three phases below; lstm_cell.cu takes the constants, and the cluster
// path of lstm_seq.cu also dot_quads and the int8 widening.
//
// One LSTM step for a tile of `bb` batch rows is three phases with a block
// barrier after each:
//
//   phase 1, gate_partials: the block's threads are laid out as 4 k-slices
//     times H column quads.  Thread (s, q) owns the four adjacent gate
//     columns 4q..4q+3 of the (.., 4H) weights and the s-th quarter of the
//     rows of w and of u.  It reads w[k][4q..4q+3] as ONE 16-byte (f32) or
//     4-byte (int8) load, neighbouring threads on neighbouring addresses,
//     and the tile's activations from shared memory (one address for the
//     whole warp, a broadcast), keeps R rows' sums in registers so that each
//     weight it loads is used R times, and leaves its partial sums in shared
//     memory.  Both products x@w and h@u are computed here, in the kernel.
//   phase 2, gate_finish: thread `col` adds the four partial sums and the
//     bias of gate column `col` and applies that column's activation, so the
//     4H threads share the transcendental work.
//   phase 3, cell_element: thread `e` owns one (row, unit) pair, reads its
//     four activated gates from shared memory and updates c and h.
//
// Why wide loads and k-slices.  Where the weights do not fit in shared
// memory (D = H = 256) every step streams them from L2, one load takes
// several hundred cycles, and what sets the pace is the bytes a block keeps
// in flight: loads outstanding per thread (bounded by registers) times
// bytes per load times threads.  One column per thread would make int8
// loads one byte wide: a quarter of the f32 bytes in flight for the same
// registers, and int8 no faster than f32.  Four columns per thread make
// every load four times as wide; slicing k four ways keeps all 4H threads
// loading.
//
// Weights are f32 or int8.  int8 weights are converted at the load and the
// per-gate-column scale multiplies the finished partial sum:
// b + sum over slices of ((x@w_q)*sw + (h@u_q)*su).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"
#include "launch.cuh"

namespace repro {

constexpr int kMaxThreads = 1024;
// What one block may use of an SM's shared memory on sm_90 (227 KB).
constexpr int kMaxSharedBytes = 232448;
// k-slices of phase 1; with four columns per thread this keeps one thread
// per gate column busy.
constexpr int kSlices = 4;

__host__ __device__ __forceinline__ int round_up4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int round_up16(int n) { return (n + 15) & ~15; }

// Floats of shared memory for the partial sums of a tile of bb rows; the
// activated gates replace slice 0 in place.
__host__ __device__ __forceinline__ int gate_floats(int bb, int hidden) {
  return kSlices * bb * 4 * hidden;
}

// Threads of a block for a hidden size: one per gate column, whole warps,
// at most 1024 (threads stride over the work beyond that).
inline int lstm_block_threads(int hidden) {
  int t = ((4 * hidden + 31) / 32) * 32;
  return t > kMaxThreads ? kMaxThreads : t;
}

// Rows a thread keeps in registers at once, for a tile of bb rows.
inline int rows_in_registers(int bb) { return bb <= 1 ? 1 : (bb <= 2 ? 2 : 4); }

// Four adjacent weights as they are loaded, and widened to f32.
template <typename WT> struct Quad;
template <> struct Quad<float> { using Raw = float4; };
template <> struct Quad<int8_t> { using Raw = uint32_t; };  // four int8, lowest address in bits 0..7
__device__ __forceinline__ float4 widen(float4 v) { return v; }
// int8 -> f32 without the int-to-float conversion instruction, which runs at
// a fraction of the FMA rate and would hold a step at D = H = 256 by itself
// (four per load).  b ^ 0x80 is b + 128 as an unsigned byte; placed in the
// low mantissa byte of 2^23 it makes the float 2^23 + 128 + b exactly, and
// one subtraction leaves b.
__device__ __forceinline__ float4 widen(uint32_t four) {
  const uint32_t biased = four ^ 0x80808080u;
  const uint32_t two23 = 0x4B000000u;
  const float offset = 8388736.0f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(biased, two23, 0x7650)) - offset,
                     __uint_as_float(__byte_perm(biased, two23, 0x7651)) - offset,
                     __uint_as_float(__byte_perm(biased, two23, 0x7652)) - offset,
                     __uint_as_float(__byte_perm(biased, two23, 0x7653)) - offset);
}
__device__ __forceinline__ void fma4(float4& acc, float a, float4 w) {
  acc.x += a * w.x;
  acc.y += a * w.y;
  acc.z += a * w.z;
  acc.w += a * w.w;
}

// acc[i] += sum over k in [k0, k1) of a_s[row_i][k] * wq[k * ldw .. +3],
// row_i = min(r0 + i, bb - 1); k0 is a multiple of 4.  Rows past the tile
// repeat its last row; the caller does not store them.  For each row and
// column the products are added in the order of k.  The weights of one
// chunk of k are all loaded before the first is used (see the note above):
// the chunk is as deep as the registers beside R rows' sums allow.
template <typename WT, int R>
__device__ __forceinline__ void dot_quads(const float* a_s, int lda, int r0, int bb,
                                          const WT* wq, int ldw, int k0, int k1,
                                          float4 (&acc)[R]) {
  using Raw = typename Quad<WT>::Raw;
  constexpr int kChunk = (sizeof(WT) == 1 ? 16 : 8) / (R <= 2 ? 1 : 2);
  const float* rows[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i < bb ? r0 + i : bb - 1;
    rows[i] = a_s + r * lda;
  }
  int k = k0;
  if ((lda & 3) == 0) {  // rows start on 16-byte boundaries: read them four at a time
    for (; k + kChunk <= k1; k += kChunk) {
      Raw wv[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) wv[q] = *reinterpret_cast<const Raw*>(wq + (k + q) * ldw);
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int q = 0; q < kChunk; q += 4) {
          const float4 a = *reinterpret_cast<const float4*>(rows[i] + k + q);
          fma4(acc[i], a.x, widen(wv[q + 0]));
          fma4(acc[i], a.y, widen(wv[q + 1]));
          fma4(acc[i], a.z, widen(wv[q + 2]));
          fma4(acc[i], a.w, widen(wv[q + 3]));
        }
      }
    }
  }
  for (; k < k1; ++k) {
    const float4 wv = widen(*reinterpret_cast<const Raw*>(wq + k * ldw));
#pragma unroll
    for (int i = 0; i < R; ++i) fma4(acc[i], rows[i][k], wv);
  }
}

// Phase 1.  part[s][r][col] = (in_s[r] @ w)[col] (* sw[col]) + (h_s[r] @ u)[col] (* su[col])
// over the s-th quarter of the rows of w and of u, for every slice s, row
// r < bb and column col < 4H.  in_s: (bb, d_in) and h_s: (bb, hidden) in
// shared memory; w: (d_in, 4H), u: (hidden, 4H) in shared or device memory,
// 16-byte aligned; sw and su are read for int8 weights only.
template <typename WT, int R>
__device__ __forceinline__ void gate_partials(const float* in_s, int d_in, const float* h_s,
                                              int hidden, const WT* w, const WT* u,
                                              const float* sw, const float* su, float* part,
                                              int bb) {
  const int gates = 4 * hidden;
  const int dx = round_up4((d_in + kSlices - 1) / kSlices);    // rows of w per slice
  const int dh = round_up4((hidden + kSlices - 1) / kSlices);  // rows of u per slice
  for (int item = threadIdx.x; item < kSlices * hidden; item += blockDim.x) {
    const int s = item / hidden, col = 4 * (item - s * hidden);
    const int x0 = min(s * dx, d_in), x1 = min(x0 + dx, d_in);
    const int h0 = min(s * dh, hidden), h1 = min(h0 + dh, hidden);
    for (int r0 = 0; r0 < bb; r0 += R) {
      float4 acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dot_quads<WT, R>(in_s, d_in, r0, bb, w + col, gates, x0, x1, acc);
      if constexpr (sizeof(WT) == 1) {  // int8: each product's partial sum times its column scales
        const float4 scale_w = *reinterpret_cast<const float4*>(sw + col);
        const float4 scale_u = *reinterpret_cast<const float4*>(su + col);
        float4 zu[R];
#pragma unroll
        for (int i = 0; i < R; ++i) zu[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        dot_quads<WT, R>(h_s, hidden, r0, bb, u + col, gates, h0, h1, zu);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i].x = acc[i].x * scale_w.x + zu[i].x * scale_u.x;
          acc[i].y = acc[i].y * scale_w.y + zu[i].y * scale_u.y;
          acc[i].z = acc[i].z * scale_w.z + zu[i].z * scale_u.z;
          acc[i].w = acc[i].w * scale_w.w + zu[i].w * scale_u.w;
        }
      } else {
        dot_quads<WT, R>(h_s, hidden, r0, bb, u + col, gates, h0, h1, acc);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (r0 + i < bb) {
          *reinterpret_cast<float4*>(part + ((long long)(s * bb + r0 + i)) * gates + col) = acc[i];
        }
      }
    }
  }
}

// Phase 2.  gates[r][col] = act_col(b[col] + sum over s of part[s][r][col]),
// written over slice 0 of `part`: each (r, col) is read and written by one
// thread only.  act_col is the tanh variant for the H columns from
// tanh_begin (the cell candidate g) and the sigmoid variant elsewhere.
__device__ __forceinline__ void gate_finish(float* part, const float* b, int bb, int hidden,
                                            int tanh_begin, int impl, const float* table) {
  const int gates = 4 * hidden;
  for (int col = threadIdx.x; col < gates; col += blockDim.x) {
    const float bias = b[col];
    const int fn = (col >= tanh_begin && col < tanh_begin + hidden) ? kTanh : kSigmoid;
    for (int r = 0; r < bb; ++r) {
      float z = bias;
#pragma unroll
      for (int s = 0; s < kSlices; ++s) z += part[((long long)(s * bb + r)) * gates + col];
      part[(long long)r * gates + col] = apply_variant(z, impl, fn, table);
    }
  }
}

// Phase 3, one (row, unit) of the cell update.  g points at the row's 4H
// activated gates; the input and forget gates sit at 0 and H, the cell
// candidate at off_g and the output gate at off_o (the sequence kernels keep
// the public order i,f,g,o for f32 weights; quantized weights are stored
// packed i,f,o,g).
__device__ __forceinline__ void cell_element(const float* g, int hidden, int j, int off_g,
                                             int off_o, float c_prev, int impl,
                                             const float* table, float* h_new, float* c_new) {
  const float c = g[hidden + j] * c_prev + g[j] * g[off_g + j];
  *c_new = c;
  *h_new = g[off_o + j] * apply_variant(c, impl, kTanh, table);
}

}  // namespace repro
