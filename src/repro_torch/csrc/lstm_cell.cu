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
// and re-reads the weights from device memory (through L2) every launch.
//
// Design: grid over batch tiles of `bb` rows; the tile's x and h are staged
// in shared memory; the three phases of lstm_common.cuh follow (partial
// sums by k-slice and column quad with coalesced 16-byte reads of w and u,
// one thread per gate column for the activation, one thread per (row, unit)
// for the cell update).  The ragged last tile simply has fewer rows: no
// padded copy of the batch is made.
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace repro {
namespace {

// Shared memory of one block, in floats: table | x tile | h tile | partial sums.
__host__ __device__ inline int cell_smem_floats(int bb, int d_in, int hidden) {
  return kLutSize + round_up4(bb * d_in) + round_up4(bb * hidden) + gate_floats(bb, hidden);
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ b,
                 const float* __restrict__ table_g, float* __restrict__ h_out,
                 float* __restrict__ c_out, int batch, int d_in, int hidden, int impl,
                 int block_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* table_s = reinterpret_cast<float*>(smem_raw);
  float* x_s = table_s + kLutSize;
  float* h_s = x_s + round_up4(block_b * d_in);
  float* g_s = h_s + round_up4(block_b * hidden);

  const int b0 = blockIdx.x * block_b;
  const int bb = min(block_b, batch - b0);
  if (impl == kLut) load_table(table_s, table_g);
  for (int e = threadIdx.x; e < bb * d_in; e += blockDim.x) x_s[e] = x[(long long)b0 * d_in + e];
  for (int e = threadIdx.x; e < bb * hidden; e += blockDim.x) h_s[e] = h[(long long)b0 * hidden + e];
  __syncthreads();

  gate_partials<float, R>(x_s, d_in, h_s, hidden, w, u, nullptr, nullptr, g_s, bb);
  __syncthreads();
  gate_finish(g_s, b, bb, hidden, 2 * hidden, impl, table_s);
  __syncthreads();

  for (int e = threadIdx.x; e < bb * hidden; e += blockDim.x) {
    const int r = e / hidden, j = e - r * hidden;
    const long long at = (long long)(b0 + r) * hidden + j;
    float hn, cn;
    cell_element(g_s + r * 4 * hidden, hidden, j, 2 * hidden, 3 * hidden, c[at], impl, table_s,
                 &hn, &cn);
    h_out[at] = hn;
    c_out[at] = cn;
  }
}

template <int R>
int launch_cell(const float* x, const float* h, const float* c, const float* w, const float* u,
                const float* b, const float* table, float* h_out, float* c_out, int batch,
                int d_in, int hidden, int impl, int block_b, int smem, cudaStream_t s) {
  static int smem_set[kMaxDevices] = {};
  const int rc = allow_smem(lstm_cell_kernel<R>, smem, smem_set);
  if (rc != 0) return rc;
  const int blocks = (batch + block_b - 1) / block_b;
  lstm_cell_kernel<R><<<blocks, lstm_block_threads(hidden), smem, s>>>(
      x, h, c, w, u, b, table, h_out, c_out, batch, d_in, hidden, impl, block_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// a = {x, h, c, w, u, b, table, h_out, c_out, batch, d_in, hidden, impl,
// block_b, smem_bytes, stream}.  x: (B, D); h, c: (B, H); w: (D, 4H);
// u: (H, 4H); b: (4H); all f32 and contiguous.  smem_bytes is the caller's
// figure for one block's shared memory; -1 is returned if it is not this
// file's.  Otherwise returns cudaGetLastError() after the launch.
extern "C" int repro_lstm_cell(const long long* a, int count) {
  using namespace repro;
  if (count != 16) return kBadArgCount;
  const int batch = static_cast<int>(a[9]), d_in = static_cast<int>(a[10]);
  const int hidden = static_cast<int>(a[11]), impl = static_cast<int>(a[12]);
  const int block_b = static_cast<int>(a[13]), smem_bytes = static_cast<int>(a[14]);
  const int smem = cell_smem_floats(block_b, d_in, hidden) * (int)sizeof(float);
  if (smem != smem_bytes || smem > kMaxSharedBytes) return -1;
  cudaStream_t s = arg_stream(a[15]);
#define REPRO_CELL(R)                                                                    \
  return launch_cell<R>(arg_ptr<const float>(a[0]), arg_ptr<const float>(a[1]),          \
                        arg_ptr<const float>(a[2]), arg_ptr<const float>(a[3]),          \
                        arg_ptr<const float>(a[4]), arg_ptr<const float>(a[5]),          \
                        arg_ptr<const float>(a[6]), arg_ptr<float>(a[7]),                \
                        arg_ptr<float>(a[8]), batch, d_in, hidden, impl, block_b, smem, s)
  switch (rows_in_registers(block_b)) {
    case 1: REPRO_CELL(1);
    case 2: REPRO_CELL(2);
    default: REPRO_CELL(4);
  }
#undef REPRO_CELL
}
