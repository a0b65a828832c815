// One fused LSTM step: z = x@w + h@u + b, gates i,f,g,o, c' = f*c + i*g,
// h' = o*tanh(c').
//
// Replaces: the Pallas TPU kernel `_kernel` launched by `_lstm_cell_call`
// in the JAX package's kernels/lstm_cell.py (public `lstm_cell_fused`).
//
// Bound on an H100: bytes at small batch (the (D+H)*4H weights are read once
// per launch and outweigh x, h, c), and in practice the launch itself: one
// step is a few microseconds of work.  This is the per-step baseline that
// the sequence kernel is compared against, so it stays one launch per step
// and reads the weights from device memory (through L2) every launch.  At
// 40x256x256 what sets its time is what the blocks pull from L2: each
// weight once per row tile and each [x | h] row once per unit group,
// 10.7 MB in all, beside the launch and the step's chain of latencies.
//
// Design: the grid splits the hidden units as well as the batch.  Block
// (rt, ug) owns kCellUnits = 8 hidden units [8 ug, 8 ug + 8) and the four
// gate columns of each (j, H+j, 2H+j, 3H+j in the public order: no permuted
// copy of the weights), for a tile of `block_b` rows; kernels/lstm_cell.py
// (`plan`) chooses the tile so that the grid is about one wave.  So a weight
// is read from L2 once per row tile, not once per batch row.  8 units make
// each gate's slice of a weight row one 32-byte sector: a narrower slice
// would pull whole sectors for a part of them, and a wider one fewer blocks.
//
// In the block: the (K, 32) slice of [w; u] (K = D + H) and the tile's
// [x | h] rows are copied into shared memory (cp.async, 16 bytes a copy
// where D and H are multiples of 4), while the cell update's c and b are
// loaded into registers; 512 threads keep more copies in flight than 256
// (measured faster at 40x256x256).  Warp (gate gi, row lane) computes the
// sums of 5 rows x 8 units of gate gi, lane l taking k = l, l + 32, ...: every
// shared-memory read is conflict-free (rows of the slice padded to 36
// floats) and each loaded value feeds 8 (or 5) FMAs.  The 32 lanes' partial
// sums are then added by shuffles, halving the values each lane holds at
// every step (40, 20, 10, 5), and the pre-activations land in shared
// memory.  A block holds all four gates of its units, so the cell
// update is local: one thread per (row, unit).  The ragged last tile and a
// last unit group past H simply have fewer rows or units.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace repro {
namespace {

constexpr int kCellUnits = 8;      // hidden units a block
constexpr int kCellThreads = 512;  // 4 gates x 4 row lanes, one warp each
constexpr int kCellRows = 5;       // rows a warp sums at once
constexpr int kCellStride = 4 * kCellUnits + 4;  // floats a row of the weight slice, padded
constexpr unsigned kFullMask = 0xffffffffu;

// Shared memory of one block, in floats:
//   table | [x | h] tile (bb, D + H) | weight slice (D + H, kCellStride) |
//   pre-activations (bb, 4 x kCellUnits)
__host__ __device__ inline int cell_smem_floats(int bb, int d_in, int hidden) {
  const int k = d_in + hidden;
  return kLutSize + round_up4(bb * k) + k * kCellStride + bb * 4 * kCellUnits;
}

// Adds the upper half of the first 2N values of this lane and its partner
// across `offset` to the lower half: afterwards v[0..N) holds the sums of
// the values the lane keeps, indices [N, 2N) if (lane & offset) else [0, N).
template <int N, int M>
__device__ __forceinline__ void fold_half(float (&v)[M], int lane, int offset) {
  const bool up = (lane & offset) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, offset);
  }
}

// The cell update of one (row, unit): z holds its four gates' sums without
// the bias, i,f,g,o.
__device__ __forceinline__ void cell_update(const float (&z)[4], const float (&bias)[4],
                                            float c_prev, int impl, const float* table,
                                            float* h_out, float* c_out) {
  const float gate_i = apply_variant(z[0] + bias[0], impl, kSigmoid, table);
  const float gate_f = apply_variant(z[1] + bias[1], impl, kSigmoid, table);
  const float gate_g = apply_variant(z[2] + bias[2], impl, kTanh, table);
  const float gate_o = apply_variant(z[3] + bias[3], impl, kSigmoid, table);
  const float cn = gate_f * c_prev + gate_i * gate_g;
  *c_out = cn;
  *h_out = gate_o * apply_variant(cn, impl, kTanh, table);
}

__global__ void __launch_bounds__(kCellThreads)
lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ b,
                 const float* __restrict__ table_g, float* __restrict__ h_out,
                 float* __restrict__ c_out, int batch, int d_in, int hidden, int impl,
                 int block_b) {
  constexpr int kCols = 4 * kCellUnits;
  const int k_all = d_in + hidden, gates = 4 * hidden;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* table_s = reinterpret_cast<float*>(smem_raw);
  float* a_s = table_s + kLutSize;                 // (bb, K): x then h
  float* w_s = a_s + round_up4(block_b * k_all);   // (K, kCellStride): gate gi at gi x 8
  float* z_s = w_s + k_all * kCellStride;          // (bb, 32): gate gi at gi x 8

  const int b0 = blockIdx.x * block_b;
  const int j0 = blockIdx.y * kCellUnits;
  const int bb = min(block_b, batch - b0);
  const int tid = threadIdx.x;
  if (impl == kLut) load_table(table_s, table_g);
  // The cell update's operands for this thread's first (row, unit), loaded
  // now so that their latency hides behind the tile's.
  const int r_first = tid / kCellUnits, j_first = j0 + tid % kCellUnits;
  float c_first = 0.0f, b_first[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (r_first < bb && j_first < hidden) {
    c_first = c[(long long)(b0 + r_first) * hidden + j_first];
#pragma unroll
    for (int g = 0; g < 4; ++g) b_first[g] = b[g * hidden + j_first];
  }

  if (d_in % 4 == 0 && hidden % 4 == 0) {  // x and h rows in 16-byte copies
    const int quads = k_all / 4;
    for (int e = tid; e < bb * quads; e += blockDim.x) {
      const int r = e / quads, k = 4 * (e - r * quads);
      const float* src = k < d_in ? x + (long long)(b0 + r) * d_in + k
                                  : h + (long long)(b0 + r) * hidden + (k - d_in);
      __pipeline_memcpy_async(a_s + r * k_all + k, src, 4 * sizeof(float));
    }
  } else {
    for (int e = tid; e < bb * k_all; e += blockDim.x) {
      const int r = e / k_all, k = e - r * k_all;
      const float* src = k < d_in ? x + (long long)(b0 + r) * d_in + k
                                  : h + (long long)(b0 + r) * hidden + (k - d_in);
      __pipeline_memcpy_async(a_s + e, src, sizeof(float));
    }
  }
  if (hidden % 4 == 0) {  // a quad of units is all in H or all past it: 16-byte copies
    for (int e = tid; e < k_all * 8; e += blockDim.x) {
      const int k = e >> 3, gi = (e >> 1) & 3, q = 4 * (e & 1);
      float* dst = w_s + k * kCellStride + gi * kCellUnits + q;
      const int j = j0 + q;
      if (j < hidden) {
        const float* row = k < d_in ? w + (long long)k * gates : u + (long long)(k - d_in) * gates;
        __pipeline_memcpy_async(dst, row + gi * hidden + j, 4 * sizeof(float));
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  } else {
    for (int e = tid; e < k_all * kCols; e += blockDim.x) {
      const int k = e / kCols, col = e - k * kCols, gi = col / kCellUnits;
      const int j = j0 + col - gi * kCellUnits;
      float* dst = w_s + k * kCellStride + col;
      if (j < hidden) {
        const float* row = k < d_in ? w + (long long)k * gates : u + (long long)(k - d_in) * gates;
        __pipeline_memcpy_async(dst, row + gi * hidden + j, sizeof(float));
      } else {
        *dst = 0.0f;
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // Warp (gi, row lane) sums 5 rows x 8 units of gate gi over k = lane,
  // lane + 32, ...; the row lanes take turns over the tile's groups of 5 rows.
  const int lane = tid & 31, warp = tid >> 5;
  const int gi = warp & 3;
  constexpr int kRowLanes = kCellThreads / 128;
  for (int rg = warp >> 2; rg * kCellRows < bb; rg += kRowLanes) {
    const float* rows[kCellRows];
#pragma unroll
    for (int m = 0; m < kCellRows; ++m) rows[m] = a_s + min(rg * kCellRows + m, bb - 1) * k_all;
    float v[kCellRows * kCellUnits];
#pragma unroll
    for (int i = 0; i < kCellRows * kCellUnits; ++i) v[i] = 0.0f;
#pragma unroll 4
    for (int k = lane; k < k_all; k += 32) {
      const float4 wa = *reinterpret_cast<const float4*>(w_s + k * kCellStride + gi * kCellUnits);
      const float4 wb =
          *reinterpret_cast<const float4*>(w_s + k * kCellStride + gi * kCellUnits + 4);
#pragma unroll
      for (int m = 0; m < kCellRows; ++m) {
        const float a = rows[m][k];
        v[m * kCellUnits + 0] += a * wa.x;
        v[m * kCellUnits + 1] += a * wa.y;
        v[m * kCellUnits + 2] += a * wa.z;
        v[m * kCellUnits + 3] += a * wa.w;
        v[m * kCellUnits + 4] += a * wb.x;
        v[m * kCellUnits + 5] += a * wb.y;
        v[m * kCellUnits + 6] += a * wb.z;
        v[m * kCellUnits + 7] += a * wb.w;
      }
    }
    // 40 sums over 32 lanes: halve to 5 a lane, then add the last 4 lanes' copies.
    fold_half<20>(v, lane, 16);
    fold_half<10>(v, lane, 8);
    fold_half<5>(v, lane, 4);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      v[i] += __shfl_xor_sync(kFullMask, v[i], 2);
      v[i] += __shfl_xor_sync(kFullMask, v[i], 1);
    }
    if ((lane & 3) == 0) {
      const int base = ((lane & 16) ? 20 : 0) + ((lane & 8) ? 10 : 0) + ((lane & 4) ? 5 : 0);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int f = base + i, r = rg * kCellRows + f / kCellUnits;
        if (r < bb) z_s[r * kCols + gi * kCellUnits + f % kCellUnits] = v[i];
      }
    }
  }
  __syncthreads();

  // One thread per (row, unit): the first from the registers loaded above,
  // any others (tiles of more than 64 rows) loading their own.
  for (int e = tid; e < bb * kCellUnits; e += blockDim.x) {
    const int r = e / kCellUnits, jj = e - r * kCellUnits, j = j0 + jj;
    if (j >= hidden) continue;
    const float* zr = z_s + r * kCols + jj;
    const float z[4] = {zr[0], zr[kCellUnits], zr[2 * kCellUnits], zr[3 * kCellUnits]};
    const long long at = (long long)(b0 + r) * hidden + j;
    if (e == tid) {
      cell_update(z, b_first, c_first, impl, table_s, h_out + at, c_out + at);
    } else {
      const float bias[4] = {b[j], b[hidden + j], b[2 * hidden + j], b[3 * hidden + j]};
      cell_update(z, bias, c[at], impl, table_s, h_out + at, c_out + at);
    }
  }
}

}  // namespace
}  // namespace repro

// a = {x, h, c, w, u, b, table, h_out, c_out, batch, d_in, hidden, impl,
// block_b, smem_bytes, stream}.  x: (B, D); h, c: (B, H); w: (D, 4H);
// u: (H, 4H); b: (4H); all f32, contiguous and 16-byte aligned.  block_b:
// rows a block; the grid is ceil(B / block_b) row tiles x ceil(H / 8) unit
// groups.  smem_bytes is the caller's figure for one block's shared memory;
// -1 is returned if it is not this file's or exceeds a block's limit, -2
// for a geometry the kernel does not take.  Otherwise returns
// cudaGetLastError() after the launch.
extern "C" int repro_lstm_cell(const long long* a, int count) {
  using namespace repro;
  if (count != 16) return kBadArgCount;
  const int batch = static_cast<int>(a[9]), d_in = static_cast<int>(a[10]);
  const int hidden = static_cast<int>(a[11]), impl = static_cast<int>(a[12]);
  const int block_b = static_cast<int>(a[13]), smem_bytes = static_cast<int>(a[14]);
  if (batch < 1 || d_in < 1 || hidden < 1 || block_b < 1) return -2;
  const int smem = cell_smem_floats(block_b, d_in, hidden) * (int)sizeof(float);
  if (smem != smem_bytes || smem > kMaxSharedBytes) return -1;
  cudaStream_t s = arg_stream(a[15]);
  static int smem_set[kMaxDevices] = {};
  const int rc = allow_smem(lstm_cell_kernel, smem, smem_set);
  if (rc != 0) return rc;
  const dim3 grid((batch + block_b - 1) / block_b, (hidden + kCellUnits - 1) / kCellUnits);
  lstm_cell_kernel<<<grid, kCellThreads, smem, s>>>(
      arg_ptr<const float>(a[0]), arg_ptr<const float>(a[1]), arg_ptr<const float>(a[2]),
      arg_ptr<const float>(a[3]), arg_ptr<const float>(a[4]), arg_ptr<const float>(a[5]),
      arg_ptr<const float>(a[6]), arg_ptr<float>(a[7]), arg_ptr<float>(a[8]), batch, d_in,
      hidden, impl, block_b);
  return static_cast<int>(cudaGetLastError());
}
