// Sequence LSTM, whole recurrence in one launch (f32 or int8 weights), and
// the layer-fused stack: L layers in one launch.
//
// Replaces: the Pallas TPU kernels of the JAX package's kernels/lstm_seq.py:
// `_kernel` launched by `_lstm_seq_call` (public `lstm_seq_fused`,
// `lstm_seq_fused_quantized`, `lstm_seq_fused_q8`) and `_stack_kernel`
// launched by `_lstm_stack_call` (public `lstm_stack_fused`).
//
// Bound on an H100: neither the card's bytes nor its operations.  The S
// steps depend on each other, so the floor is S times the latency of one
// step, and one step is a (bb, D+H) x (D+H, 4H) product plus three block
// barriers.  Compulsory traffic (x in, hs out, weights once) is a few
// megabytes at most at the sizes this repository runs.
//
// Design.  The grid walks batch tiles only; the time loop, and for the stack
// the layer loop, run inside the kernel, so h and c never leave shared
// memory and there is one launch per call instead of S (or L).  The tile's
// x[t] is read straight from the batch-major (B, S, D) input (copied
// asynchronously into shared memory one step ahead, so its latency hides
// behind the products) and h[t] written straight to the batch-major
// (B, S, H) output, so no time-major copy is made.  The input projection is
// computed per step from x[t] rather than for the whole sequence up front:
// a (S, bb, 4H) f32 buffer does not fit a block's shared memory at H = 256,
// and this card needs no large product to be busy.
//
// Where the weights live ("resident").  If one layer's w and u, at their
// stored width, fit in the block's shared memory beside the tile's state
// (`resident` = 1), the block copies them in once per layer and every step
// reads them from there: the paper's shape (8.3 KB in f32) and the small
// bench widths.  If they do not fit (D = H = 256: u alone is 1 MB in f32 and
// 256 KB in int8, over the 227 KB a block may use) every step reads them
// from device memory; they stay in the 50 MB L2 between steps, and int8
// cuts that per-step traffic to a quarter.  Splitting the gate columns
// over a thread-block cluster, so that each block's share does fit, is the
// next step and is not done here.
//
// The stack keeps the inter-layer h sequence in a (S, bb, H) f32 buffer in
// shared memory.  Layer l+1 at step t reads row t as its input in phase 1
// and, two barriers later, overwrites row t with its own h[t] in phase 3:
// every read of a row is fenced from the write that replaces it.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace repro {
namespace {

// Shared memory of one block, in bytes.  Floats first:
//   table | h | c | partial sums and gates | x[t], x[t+1] tiles |
//   inter-layer sequence (stack only)
// then, when resident, one layer's w and u at their stored width.
__host__ __device__ inline int seq_smem_bytes(int bb, int seq, int d_in, int hidden, int layers,
                                              int wbytes, int resident) {
  int floats = kLutSize + 2 * round_up4(bb * hidden) + gate_floats(bb, hidden) +
               2 * round_up4(bb * d_in);
  if (layers > 1) floats += round_up4(seq * bb * hidden);
  int bytes = floats * 4;
  if (resident) {
    const int w_rows = (layers > 1 && hidden > d_in) ? hidden : d_in;
    bytes += round_up16(w_rows * 4 * hidden * wbytes) + round_up16(hidden * 4 * hidden * wbytes);
  }
  return bytes;
}

struct Tile {
  float* table;
  float* h;
  float* c;
  float* gates;     // partial sums (4, bb, 4H); slice 0 becomes the activated gates
  float* x[2];      // x[t] tiles, double-buffered
  float* seq;       // (S, block_b, H), stack only
  void* w;          // resident copies, or nullptr
  void* u;
};

__device__ inline Tile carve(unsigned char* smem, int block_b, int seq, int d_in, int hidden,
                             int layers, int wbytes, int resident) {
  Tile t;
  t.table = reinterpret_cast<float*>(smem);
  t.h = t.table + kLutSize;
  t.c = t.h + round_up4(block_b * hidden);
  t.gates = t.c + round_up4(block_b * hidden);
  t.x[0] = t.gates + gate_floats(block_b, hidden);
  t.x[1] = t.x[0] + round_up4(block_b * d_in);
  t.seq = t.x[1] + round_up4(block_b * d_in);
  float* end = t.seq + (layers > 1 ? round_up4(seq * block_b * hidden) : 0);
  t.w = nullptr;
  t.u = nullptr;
  if (resident) {
    const int w_rows = (layers > 1 && hidden > d_in) ? hidden : d_in;
    unsigned char* wp = reinterpret_cast<unsigned char*>(end);
    t.w = wp;
    t.u = wp + round_up16(w_rows * 4 * hidden * wbytes);
  }
  return t;
}

// One layer's recurrence for the tile of rows [b0, b0 + bb).
//   x_g != nullptr: the layer's input is x_g, batch-major (B, S, d_in) in
//     device memory; x[t+1] is copied into tile.x while step t computes.
//   x_g == nullptr: the input is tile.seq, the previous layer's h sequence.
//   hs_g != nullptr: h[t] goes to the batch-major (B, S, H) output.
//   write_seq: h[t] replaces row t of tile.seq, for the next layer.
// w_g, u_g: this layer's weights in device memory.  hn_g, cn_g: (B, H).
// The caller has synchronised the block since tile.seq was last written.
template <typename WT, int R>
__device__ void run_layer(const Tile& tile, const float* x_g, int d_in, float* hs_g,
                          bool write_seq, const WT* w_g, const WT* u_g, const float* b,
                          const float* sw, const float* su, float* hn_g, float* cn_g, int b0,
                          int bb, int seq, int hidden, int impl, int packed) {
  const int gates = 4 * hidden;
  // Gate columns: public order i,f,g,o, or packed i,f,o,g (the stored layout
  // of quantized weights).  The order only decides which H columns get tanh.
  const int off_g = (packed ? 3 : 2) * hidden, off_o = (packed ? 2 : 3) * hidden;
  const int in_dim = x_g ? d_in : hidden;
  const WT* w = w_g;
  const WT* u = u_g;
  if (tile.w) {  // copy this layer's weights into shared memory, once
    WT* w_s = static_cast<WT*>(tile.w);
    WT* u_s = static_cast<WT*>(tile.u);
    for (int e = threadIdx.x; e < in_dim * gates; e += blockDim.x) w_s[e] = w_g[e];
    for (int e = threadIdx.x; e < hidden * gates; e += blockDim.x) u_s[e] = u_g[e];
    w = w_s;
    u = u_s;
  }
  for (int e = threadIdx.x; e < bb * hidden; e += blockDim.x) {
    tile.h[e] = 0.0f;
    tile.c[e] = 0.0f;
  }
  const long long x_row = (long long)seq * d_in;  // stride between batch rows of x
  // Asynchronous copy of x[t] for the tile into buffer t % 2.
  auto fetch_x = [&](int t) {
    float* dst = tile.x[t & 1];
    for (int e = threadIdx.x; e < bb * d_in; e += blockDim.x) {
      const int r = e / d_in, k = e - r * d_in;
      __pipeline_memcpy_async(dst + e, x_g + (b0 + r) * x_row + (long long)t * d_in + k,
                              sizeof(float));
    }
    __pipeline_commit();
  };
  if (x_g) {
    fetch_x(0);
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  for (int t = 0; t < seq; ++t) {
    // Buffer (t + 1) % 2 was last read in step t - 1, before its barriers.
    if (x_g && t + 1 < seq) fetch_x(t + 1);
    const float* in_s = x_g ? tile.x[t & 1] : tile.seq + (long long)t * bb * hidden;
    gate_partials<WT, R>(in_s, in_dim, tile.h, hidden, w, u, sw, su, tile.gates, bb);
    __syncthreads();  // partial sums complete; every read of x[t], seq[t] and h[t-1] is done
    gate_finish(tile.gates, b, bb, hidden, off_g, impl, tile.table);
    __syncthreads();  // activated gates complete

    for (int e = threadIdx.x; e < bb * hidden; e += blockDim.x) {
      const int r = e / hidden, j = e - r * hidden;
      float hn, cn;
      cell_element(tile.gates + r * gates, hidden, j, off_g, off_o, tile.c[e], impl,
                   tile.table, &hn, &cn);
      tile.h[e] = hn;
      tile.c[e] = cn;
      if (write_seq) tile.seq[(long long)t * bb * hidden + e] = hn;
      if (hs_g) hs_g[((long long)(b0 + r) * seq + t) * hidden + j] = hn;
      if (t == seq - 1) {
        hn_g[(long long)(b0 + r) * hidden + j] = hn;
        cn_g[(long long)(b0 + r) * hidden + j] = cn;
      }
    }
    if (x_g) __pipeline_wait_prior(0);
    __syncthreads();  // h[t], seq[t] and x[t+1] visible to the next step
  }
}

// Single layer.  w: (D, 4H), u: (H, 4H); gate columns i,f,g,o, or i,f,o,g if `packed`.
template <typename WT, int R>
__global__ void __launch_bounds__(kMaxThreads)
lstm_seq_kernel(const float* __restrict__ x, const WT* __restrict__ w, const WT* __restrict__ u,
                const float* __restrict__ b, const float* __restrict__ sw,
                const float* __restrict__ su, const float* __restrict__ table_g,
                float* __restrict__ hs, float* __restrict__ hn, float* __restrict__ cn,
                int batch, int seq, int d_in, int hidden, int impl, int packed, int block_b,
                int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile tile = carve(smem_raw, block_b, seq, d_in, hidden, 1, sizeof(WT), resident);
  const int b0 = blockIdx.x * block_b;
  const int bb = min(block_b, batch - b0);
  if (impl == kLut) load_table(tile.table, table_g);  // run_layer synchronises before step 0
  run_layer<WT, R>(tile, x, d_in, hs, false, w, u, b, sw, su, hn, cn, b0, bb, seq, hidden, impl,
                   packed);
}

// L >= 2 layers.  w0: (D, 4H); wr: (L-1, H, 4H); us: (L, H, 4H); bs, sws,
// sus: (L, 4H); hn, cn: (L, B, H).  Gate columns i,f,g,o, or i,f,o,g if `packed`.
template <typename WT, int R>
__global__ void __launch_bounds__(kMaxThreads)
lstm_stack_kernel(const float* __restrict__ x, const WT* __restrict__ w0,
                  const WT* __restrict__ wr, const WT* __restrict__ us,
                  const float* __restrict__ bs, const float* __restrict__ sws,
                  const float* __restrict__ sus, const float* __restrict__ table_g,
                  float* __restrict__ hs, float* __restrict__ hn, float* __restrict__ cn,
                  int batch, int seq, int d_in, int hidden, int layers, int impl, int packed,
                  int block_b, int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile tile = carve(smem_raw, block_b, seq, d_in, hidden, layers, sizeof(WT), resident);
  const int b0 = blockIdx.x * block_b;
  const int bb = min(block_b, batch - b0);
  const int gates = 4 * hidden;
  if (impl == kLut) load_table(tile.table, table_g);
  for (int l = 0; l < layers; ++l) {
    const bool last = (l == layers - 1);
    const WT* w = l == 0 ? w0 : wr + (long long)(l - 1) * hidden * gates;
    run_layer<WT, R>(tile, l == 0 ? x : nullptr, d_in, last ? hs : nullptr, !last, w,
                     us + (long long)l * hidden * gates, bs + l * gates,
                     sws ? sws + l * gates : nullptr, sus ? sus + l * gates : nullptr,
                     hn + (long long)l * batch * hidden, cn + (long long)l * batch * hidden, b0,
                     bb, seq, hidden, impl, packed);
    // run_layer ends on a barrier: the next layer may overwrite the
    // resident weights and reset h and c.
  }
}

template <typename WT, int R>
int launch_seq(const void* x, const void* w, const void* u, const void* b, const void* sw,
               const void* su, const void* table, void* hs, void* hn, void* cn, int batch,
               int seq, int d_in, int hidden, int impl, int packed, int block_b, int resident,
               int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lstm_seq_kernel<WT, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (batch + block_b - 1) / block_b;
  lstm_seq_kernel<WT, R><<<blocks, lstm_block_threads(hidden), smem, s>>>(
      (const float*)x, (const WT*)w, (const WT*)u, (const float*)b, (const float*)sw,
      (const float*)su, (const float*)table, (float*)hs, (float*)hn, (float*)cn, batch, seq,
      d_in, hidden, impl, packed, block_b, resident);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT, int R>
int launch_stack(const void* x, const void* w0, const void* wr, const void* us, const void* bs,
                 const void* sws, const void* sus, const void* table, void* hs, void* hn,
                 void* cn, int batch, int seq, int d_in, int hidden, int layers, int impl,
                 int packed, int block_b, int resident, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lstm_stack_kernel<WT, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (batch + block_b - 1) / block_b;
  lstm_stack_kernel<WT, R><<<blocks, lstm_block_threads(hidden), smem, s>>>(
      (const float*)x, (const WT*)w0, (const WT*)wr, (const WT*)us, (const float*)bs,
      (const float*)sws, (const float*)sus, (const float*)table, (float*)hs, (float*)hn,
      (float*)cn, batch, seq, d_in, hidden, layers, impl, packed, block_b, resident);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

#define REPRO_BY_ROWS(CALL, WT)                   \
  switch (repro::rows_in_registers(block_b)) {    \
    case 1: return CALL(WT, 1);                   \
    case 2: return CALL(WT, 2);                   \
    default: return CALL(WT, 4);                  \
  }

// x: (B, S, D) f32; w: (D, 4H), u: (H, 4H), f32 (quantized == 0) or int8
// (quantized == 1), gate columns i,f,g,o (packed == 0) or i,f,o,g
// (packed == 1); b, sw, su: (4H) f32 (sw and su are read only when
// quantized); hs: (B, S, H); hn, cn: (B, H).  All
// contiguous.  smem_bytes is the caller's figure for one block's shared
// memory; -1 is returned if it is not this file's or exceeds a block's
// limit.  Otherwise returns cudaGetLastError() after the launch.
extern "C" int repro_lstm_seq(const void* x, const void* w, const void* u, const void* b,
                              const void* sw, const void* su, const void* table, void* hs,
                              void* hn, void* cn, int batch, int seq, int d_in, int hidden,
                              int impl, int quantized, int packed, int block_b, int resident,
                              int smem_bytes, void* stream) {
  const int smem =
      repro::seq_smem_bytes(block_b, seq, d_in, hidden, 1, quantized ? 1 : 4, resident);
  if (smem != smem_bytes || smem > repro::kMaxSharedBytes) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SEQ(WT, R)                                                                        \
  repro::launch_seq<WT, R>(x, w, u, b, sw, su, table, hs, hn, cn, batch, seq, d_in, hidden, impl, \
                           packed, block_b, resident, smem, s)
  if (quantized) {
    REPRO_BY_ROWS(REPRO_SEQ, int8_t)
  } else {
    sw = nullptr;
    su = nullptr;
    REPRO_BY_ROWS(REPRO_SEQ, float)
  }
#undef REPRO_SEQ
}

// As repro_lstm_seq for `layers` >= 2 layers: w0: (D, 4H); wr: (L-1, H, 4H);
// us: (L, H, 4H); bs, sws, sus: (L, 4H); hn, cn: (L, B, H).
extern "C" int repro_lstm_stack(const void* x, const void* w0, const void* wr, const void* us,
                                const void* bs, const void* sws, const void* sus,
                                const void* table, void* hs, void* hn, void* cn, int batch,
                                int seq, int d_in, int hidden, int layers, int impl,
                                int quantized, int packed, int block_b, int resident,
                                int smem_bytes, void* stream) {
  if (layers < 2) return -2;
  const int smem =
      repro::seq_smem_bytes(block_b, seq, d_in, hidden, layers, quantized ? 1 : 4, resident);
  if (smem != smem_bytes || smem > repro::kMaxSharedBytes) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_STACK(WT, R)                                                                     \
  repro::launch_stack<WT, R>(x, w0, wr, us, bs, sws, sus, table, hs, hn, cn, batch, seq, d_in, \
                             hidden, layers, impl, packed, block_b, resident, smem, s)
  if (quantized) {
    REPRO_BY_ROWS(REPRO_STACK, int8_t)
  } else {
    sws = nullptr;
    sus = nullptr;
    REPRO_BY_ROWS(REPRO_STACK, float)
  }
#undef REPRO_STACK
}
