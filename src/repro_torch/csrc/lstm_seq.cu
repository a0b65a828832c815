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
// step, and one step is a (bb, H) x (H, 4H) product plus the barriers that
// fence it.  Compulsory traffic (x in, hs out, weights once) is a few
// megabytes at most at the sizes this repository runs.
//
// The time loop, and for the stack the layer loop, run inside the kernel, so
// h and c never leave shared memory and there is one launch per call instead
// of S (or L).  x is read from the batch-major (B, S, D) input and h[t]
// written straight to the batch-major (B, S, H) output: no time-major copy.
// Where the weights live sets the design; kernels/lstm_seq.py:plan_launch
// picks one of three paths, for one layer and for a stack alike, and the
// wrapper passes its geometry here.
//
// 1. One block per batch tile, weights resident (`lstm_seq_kernel`,
//    `lstm_stack_kernel`, resident = 1).  If one layer's w and u, at their
//    stored width, fit in a block's shared memory beside the tile's state,
//    the block copies them in once (a stack: once per layer) and every step
//    reads them there: the paper's shape (8.3 KB in f32) and the small bench
//    widths.  x[t] is copied one step ahead (cp.async) and x[t]·w computed
//    per step beside h·u.
//
// 2. A thread-block cluster per batch tile, u resident across it
//    (`lstm_cluster_kernel`; one layer is a stack of L = 1).  At D = H = 256
//    u alone is 1 MB in f32 (256 KB in int8), over the 227 KB a block may
//    use.  A cluster of C = 8 blocks (kCluster: the most sm_90 allows without
//    opting in, and the fastest size measured at D = H = 256) splits the H
//    hidden units: block `rank` owns units [rank H/C, (rank+1) H/C) and
//    their 4H/C gate columns, and keeps its (H, 4H/C) slice of u in shared
//    memory for the whole sequence (128 KB in f32), the four gates of a
//    unit side by side.  As the JAX kernel does (`_input_projection`), the input
//    projection x·w + b is computed ahead of the recurrence, `chunk` steps at
//    a time (all S when they fit), x and w arriving through a double-buffered
//    cp.async stage; the recurrence then multiplies h by u only.  One step:
//    each block forms h·u_slice for its columns (k split over its threads,
//    partial sums in shared memory), then one thread per (row, unit) applies
//    the four gates, updates c and h, and stores h into the next-step h
//    buffer of every other block with st.async, which counts the bytes on
//    that block's mbarrier for the buffer.  A block starts a step when its
//    mbarrier says the other blocks' parts of h have all arrived: no block
//    waits for its stores to be acknowledged, and no cluster-wide barrier
//    runs inside the loop.  h is double-buffered, and a block can store into
//    a buffer only after every block has sent the h it needs to fill the
//    other one, so no store overtakes a read.  Clusters walk the batch,
//    `block_b` rows each.  A stack runs its layers one after another in the
//    same cluster: each layer loads its u slice, and projects the h sequence
//    of the layer before, which goes through a (B, S, H) buffer in device
//    memory (it stays in L2; a block could not hold all S steps of its rows
//    beside u's slice), with one cluster barrier between layers.  Bound: the
//    FMAs of the projection and of h·u at a few rows a block, and each step's
//    latency chain (partial sums, five activations, the store to the other
//    blocks).
//
// 3. One block per batch tile, weights re-read from L2 each step
//    (`lstm_seq_kernel`, `lstm_stack_kernel`, resident = 0): where neither
//    fits (H/C not a multiple of 4, or a slice of u too wide for a block).
//    One SM draws ~90 GB/s from L2: a step took ~23 us at D = H = 256
//    before that width had the cluster path.
//
// On paths 1 and 3 a stack keeps the inter-layer h sequence in a (S, bb, H)
// f32 buffer in shared memory.  Layer l+1 at step t reads row t as its input
// in phase 1 and, two barriers later, overwrites row t with its own h[t] in
// phase 3: every read of a row is fenced from the write that replaces it.
#include <cooperative_groups.h>
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

// One layer's operands: w (rows, 4H), u (H, 4H), b (4H) and, for int8
// weights, the per-column scales sw and su (4H; null for f32 weights).
template <typename WT>
struct LayerOperands {
  const WT* w;
  const WT* u;
  const float* b;
  const float* sw;
  const float* su;
};

// Layer l's operands.  Layer 0's arrive by value; those of layers 1 .. L-1
// as a table in device memory of five addresses a layer (w, u, b, sw, su;
// 0 for an absent scale), so that a stack's weights need not be stacked
// into one tensor on every call.
template <typename WT>
__device__ __forceinline__ LayerOperands<WT> layer_operands(const LayerOperands<WT>& first,
                                                            const long long* rest, int l) {
  if (l == 0) return first;
  const long long* p = rest + 5 * (l - 1);
  return {reinterpret_cast<const WT*>(p[0]), reinterpret_cast<const WT*>(p[1]),
          reinterpret_cast<const float*>(p[2]), reinterpret_cast<const float*>(p[3]),
          reinterpret_cast<const float*>(p[4])};
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

// L >= 2 layers (layer_operands: layer 0's w is (D, 4H), the others' (H,
// 4H)); hn, cn: (L, B, H).  Gate columns i,f,g,o, or i,f,o,g if `packed`.
template <typename WT, int R>
__global__ void __launch_bounds__(kMaxThreads)
lstm_stack_kernel(const float* __restrict__ x, const LayerOperands<WT> first,
                  const long long* __restrict__ rest, const float* __restrict__ table_g,
                  float* __restrict__ hs, float* __restrict__ hn, float* __restrict__ cn,
                  int batch, int seq, int d_in, int hidden, int layers, int impl, int packed,
                  int block_b, int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile tile = carve(smem_raw, block_b, seq, d_in, hidden, layers, sizeof(WT), resident);
  const int b0 = blockIdx.x * block_b;
  const int bb = min(block_b, batch - b0);
  if (impl == kLut) load_table(tile.table, table_g);
  for (int l = 0; l < layers; ++l) {
    const bool last = (l == layers - 1);
    const LayerOperands<WT> op = layer_operands(first, rest, l);
    run_layer<WT, R>(tile, l == 0 ? x : nullptr, d_in, last ? hs : nullptr, !last, op.w, op.u,
                     op.b, op.sw, op.su, hn + (long long)l * batch * hidden,
                     cn + (long long)l * batch * hidden, b0, bb, seq, hidden, impl, packed);
    // run_layer ends on a barrier: the next layer may overwrite the
    // resident weights and reset h and c.
  }
}

// ---------------------------------------------------------------------------
// Path 2: a cluster per batch tile, u resident across the cluster
// ---------------------------------------------------------------------------
constexpr int kCluster = 8;  // blocks a cluster: the most sm_90 allows without opting in
constexpr int kClusterThreads = 256;
constexpr int kProjRows = 12;  // most rows a thread sums at once in the input projection
constexpr int kProjK = 16;     // k of the x and w rows staged at once for the projection
constexpr int kBarrierBytes = 16;  // two mbarriers at the start of a cluster block's memory

// A cluster can split `hidden` units: each block's H/C units form whole
// quads of columns (four adjacent, one 16-byte load), and its column quads
// do not outnumber its threads.
inline bool cluster_shape_ok(int hidden) {
  return hidden % (4 * kCluster) == 0 && hidden / kCluster <= kClusterThreads;
}

// Threads per column quad: the k-slices of a step's h·u, and the row lanes
// of the input projection.  A block has H/C column quads (4H/C columns).
__host__ __device__ inline int cluster_lanes(int hidden, int cluster) {
  return kClusterThreads / (hidden / cluster);
}

// Floats of one of the projection's two stage buffers: x rows (lanes x
// kProjRows, kProjK) in f32, then w rows (kProjK, 4H/C) at their stored width.
__host__ __device__ inline int proj_stage_floats(int hidden, int cluster, int wbytes) {
  return cluster_lanes(hidden, cluster) * kProjRows * kProjK +
         kProjK * 4 * (hidden / cluster) * wbytes / 4;
}

// Floats of the region that holds a step's partial sums (lanes, bb, 4H/C)
// and, while the input projection runs, its two stage buffers.
__host__ __device__ inline int cluster_scratch_floats(int bb, int hidden, int cluster,
                                                      int wbytes) {
  const int partials = cluster_lanes(hidden, cluster) * bb * 4 * (hidden / cluster);
  const int stages = 2 * proj_stage_floats(hidden, cluster, wbytes);
  return partials > stages ? partials : stages;
}

// Shared memory of one block of the cluster path, in bytes: two mbarriers,
// then floats:
//   table | h, two (bb, H) buffers | c (bb, H/C) | scratch | zx (chunk, bb, 4H/C)
// then the block's slice of u, (H, 4H/C) at its stored width.
__host__ __device__ inline int cluster_smem_bytes(int bb, int chunk, int hidden, int cluster,
                                                  int wbytes) {
  const int hc = hidden / cluster;
  const int floats = kLutSize + 2 * round_up4(bb * hidden) + round_up4(bb * hc) +
                     cluster_scratch_floats(bb, hidden, cluster, wbytes) + chunk * bb * 4 * hc;
  return kBarrierBytes + floats * 4 + round_up16(hidden * 4 * hc * wbytes);
}

// The h exchange.  A block stores each h value it owns straight into the
// next-step h buffer of every other block of the cluster with st.async,
// which also counts its bytes on the receiver's mbarrier of that buffer
// (complete_tx); the receiver's thread 0 arms the mbarrier with the bytes
// it expects (arrive.expect_tx), and its threads wait for the phase.  No
// block waits for its own stores to be acknowledged, and none waits for
// blocks whose data it does not need yet.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void push_value(uint32_t remote, float v, uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(remote), "r"(__float_as_uint(v)), "r"(remote_bar) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 state;\n"
               " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the phase of `bar` with parity `parity` to complete.  A phase
// that never completes means a lost store, a fault: after about two seconds
// the kernel traps, and the launch fails instead of hanging the card.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

// 16 bytes from device memory into shared memory through L2 alone
// (cp.async.cg).  A stack's inter-layer sequence is written by the other SMs
// of the cluster, and L1 is not coherent across SMs: no copy of it may come
// from a line an SM's L1 kept from an earlier layer.
__device__ __forceinline__ void copy16_l2(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Copies k-chunk [k0, k0 + kx) of the projection's operands into a stage
// buffer, asynchronously (cp.async), and commits them as one group: rows
// [m0, m0 + rows) of x (row m = tt * bb + r is batch row b0 + r at step
// t0 + tt) and the same rows of w in the block's columns, four columns to a copy.
template <typename WT>
__device__ void stage_projection(const float* x, const WT* w, float* xs, WT* ws, int m0,
                                 int rows, int k0, int kx, int b0, int bb, int t0, int seq,
                                 int d_in, int hidden, int hc, int g4, int rank, bool x_vec) {
  if (x_vec) {  // 16-byte copies: D a multiple of 4 and x 16-byte aligned
    constexpr int kQuads = kProjK / 4;
    for (int e = threadIdx.x; e < rows * kQuads; e += blockDim.x) {
      const int g = e / kQuads, kq = 4 * (e - g * kQuads);
      if (kq < kx) {
        const int m = m0 + g, tt = m / bb, r = m - tt * bb;
        copy16_l2(xs + g * kProjK + kq, x + ((long long)(b0 + r) * seq + t0 + tt) * d_in + k0 + kq);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * kProjK; e += blockDim.x) {
      const int g = e / kProjK, kk = e - g * kProjK;
      if (kk < kx) {
        const int m = m0 + g, tt = m / bb, r = m - tt * bb;
        __pipeline_memcpy_async(xs + e, x + ((long long)(b0 + r) * seq + t0 + tt) * d_in + k0 + kk,
                                4);
      }
    }
  }
  for (int e = threadIdx.x; e < kx * hc; e += blockDim.x) {
    const int kk = e / hc, q4 = 4 * (e - kk * hc);
    const int gcol = (q4 / hc) * hidden + rank * hc + q4 % hc;
    __pipeline_memcpy_async(ws + kk * g4 + q4, w + (long long)(k0 + kk) * 4 * hidden + gcol,
                            4 * sizeof(WT));
  }
  __pipeline_commit();
}

// zx[m][4 jj + gi], m = tt * bb + r, for the steps t0 + tt < t0 + steps:
// row r of the tile's x at step t0 + tt times the block's gate columns of
// w, times the column scale for int8 weights, plus the bias: the plain
// version's (x·w) (* sw) + b, rounded in that order.  Here a thread's
// column quad c4 is four adjacent global columns (units c4 % hc .. + 3 of
// gate c4 / hc), so that w arrives in 16-byte copies; it writes them to
// their interleaved places in zx.  Rows are taken lanes x RP at a time;
// their x and the block's w arrive kProjK rows of k at a time through two
// stage buffers in the scratch, the next chunk copied while the current
// one is multiplied.  Ends on a barrier after the last read of the stages;
// zx is written after it.
template <typename WT, int RP>
__device__ void project_rows(const float* x, const WT* w, const float* b, const float* sw,
                             float* zx, float* scratch, int b0, int bb, int t0, int steps,
                             int seq, int d_in, int hidden, int hc, int g4, int rank, int lane,
                             int lanes, int c4, int col, bool x_vec) {
  const int total = steps * bb, group = lanes * RP;
  const int stage_x = lanes * kProjRows * kProjK;
  const int stage = stage_x + kProjK * g4 * static_cast<int>(sizeof(WT)) / 4;
  float* const xs0 = scratch;
  float* const xs1 = scratch + stage;
  WT* const ws0 = reinterpret_cast<WT*>(scratch + stage_x);
  WT* const ws1 = reinterpret_cast<WT*>(scratch + stage + stage_x);
  const int chunks = (d_in + kProjK - 1) / kProjK;
  const bool active = lane < lanes;
  for (int m0 = 0; m0 < total; m0 += group) {
    const int rows = min(group, total - m0);
    float4 acc[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    stage_projection<WT>(x, w, xs0, ws0, m0, rows, 0, min(kProjK, d_in), b0, bb, t0, seq, d_in,
                         hidden, hc, g4, rank, x_vec);
    for (int kc = 0; kc < chunks; ++kc) {
      const int k0 = kc * kProjK;
      const bool odd = kc & 1;
      if (kc + 1 < chunks) {
        stage_projection<WT>(x, w, odd ? xs0 : xs1, odd ? ws0 : ws1, m0, rows, k0 + kProjK,
                             min(kProjK, d_in - k0 - kProjK), b0, bb, t0, seq, d_in, hidden, hc,
                             g4, rank, x_vec);
      } else {
        __pipeline_commit();  // an empty group, so that one wait rule fits every chunk
      }
      __pipeline_wait_prior(1);  // this thread's copies of chunk kc have landed
      __syncthreads();           // ... and every thread's
      if (active) {
        dot_quads<WT, RP>(odd ? xs1 : xs0, kProjK, lane * RP, rows, (odd ? ws1 : ws0) + c4, g4, 0,
                          min(kProjK, d_in - k0), acc);
      }
      __syncthreads();  // chunk kc's buffer is free for chunk kc + 2
    }
    if (active) {
      const float4 bias = *reinterpret_cast<const float4*>(b + col);
      float4 scale = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      if constexpr (sizeof(WT) == 1) scale = *reinterpret_cast<const float4*>(sw + col);
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int g = lane * RP + i;
        if (g < rows) {
          float4 v = acc[i];
          if constexpr (sizeof(WT) == 1) {
            v = make_float4(__fmul_rn(v.x, scale.x), __fmul_rn(v.y, scale.y),
                            __fmul_rn(v.z, scale.z), __fmul_rn(v.w, scale.w));
          }
          v = make_float4(__fadd_rn(v.x, bias.x), __fadd_rn(v.y, bias.y),
                          __fadd_rn(v.z, bias.z), __fadd_rn(v.w, bias.w));
          // units jj0 .. jj0 + 3 of gate gi, at their interleaved columns
          float* row = zx + (long long)(m0 + g) * g4 + 4 * (c4 % hc) + c4 / hc;
          row[0] = v.x;
          row[4] = v.y;
          row[8] = v.z;
          row[12] = v.w;
        }
      }
    }
  }
}

// The projection of `steps` steps: 12 rows a thread where the rows fill
// them, else 4 (so that a small tile does not compute 12 for a few).
template <typename WT>
__device__ void project_inputs(const float* x, const WT* w, const float* b, const float* sw,
                               float* zx, float* scratch, int b0, int bb, int t0, int steps,
                               int seq, int d_in, int hidden, int hc, int g4, int rank, int lane,
                               int lanes, int c4, int col, bool x_vec) {
  if (steps * bb > 4 * lanes) {
    project_rows<WT, kProjRows>(x, w, b, sw, zx, scratch, b0, bb, t0, steps, seq, d_in, hidden,
                                hc, g4, rank, lane, lanes, c4, col, x_vec);
  } else {
    project_rows<WT, 4>(x, w, b, sw, zx, scratch, b0, bb, t0, steps, seq, d_in, hidden, hc, g4,
                        rank, lane, lanes, c4, col, x_vec);
  }
}

// L >= 1 layers, one cluster per tile of `block_b` batch rows; cluster dims
// (C, 1, 1), so blockIdx.x / C is the tile.  K3 is this kernel at L = 1.
// layer_operands: layer 0's w is (D, 4H), the others' (H, 4H); hn, cn:
// (L, B, H); gate columns i,f,g,o, or i,f,o,g if `packed`.  Block
// `rank` owns hidden units [rank hc, rank hc + hc), hc = H / C.  In shared
// memory (u's slice, the partial sums, zx) its 4 hc gate columns are
// interleaved: local column 4 jj + gi is gate block gi of unit jj, global
// column gi H + rank hc + jj, so that the four gates of a unit are one
// 16-byte load.
//
// The inter-layer sequence: layer l writes its h sequence, (B, S, H)
// batch-major, to `hs` or to the workspace `seq_ws`, alternating so that
// the last layer writes `hs`, and layer l + 1 projects it as its input.  A
// cluster reads and writes only its own batch rows, so one cluster barrier
// (release, then acquire) at the start of each layer orders everything a
// layer needs: every block's stores of layer l - 1's sequence are visible,
// no block still reads an h buffer of layer l - 1's last step when another
// pushes layer l's first h into it, and no block still reads the buffer
// that layer l overwrites (two layers back).  The sequence is copied in
// with cp.async.cg (L2 only, copy16_l2).  Each mbarrier's phase parity is
// carried across layers (`parity`): how many phases a buffer completes in a
// layer depends on S.
template <typename WT, int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
lstm_cluster_kernel(const float* __restrict__ x, const LayerOperands<WT> first,
                    const long long* __restrict__ rest, const float* __restrict__ table_g, float* hs,
                    float* seq_ws, float* __restrict__ hn, float* __restrict__ cn, int batch,
                    int seq, int d_in, int hidden, int layers, int impl, int packed, int block_b,
                    int chunk) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int hc = hidden / csize, g4 = 4 * hc, gates = 4 * hidden;
  const int lanes = kClusterThreads / hc;
  const int tid = threadIdx.x;
  const int lane = tid / hc;                 // k-slice of a step, row lane of the projection
  const int unit = tid - lane * hc;          // a step's columns: the 4 gates of this unit
  const int c4 = 4 * unit;                   // the projection's: 4 units of one gate block,
  const int col = (c4 / hc) * hidden + rank * hc + c4 % hc;  // global columns col .. col + 3

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // full[b]: the other blocks' parts of the h in buffer b have arrived
  const uint32_t full0 = smem_addr(smem_raw), full1 = full0 + 8;
  float* table_s = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
  float* h0 = table_s + kLutSize;  // h of even steps' input; h1 of odd ones'
  float* h1 = h0 + round_up4(block_b * hidden);
  float* c_s = h1 + round_up4(block_b * hidden);
  float* scratch = c_s + round_up4(block_b * hc);
  float* zx = scratch + cluster_scratch_floats(block_b, hidden, csize, sizeof(WT));
  WT* u_s = reinterpret_cast<WT*>(zx + chunk * block_b * g4);

  const int b0 = (blockIdx.x / csize) * block_b;
  const int bb = min(block_b, batch - b0);

  if (impl == kLut) load_table(table_s, table_g);
  // What a block receives of each step's h: the other blocks' units, all rows.
  const uint32_t bytes_in = static_cast<uint32_t>((csize - 1) * bb * hc * sizeof(float));
  const int ks = round_up4((hidden + lanes - 1) / lanes);  // k of h·u per slice
  const int k0 = min(lane * ks, hidden), k1 = min(k0 + ks, hidden);
  const int gate_g = packed ? 3 : 2;  // gate block of the cell candidate g; o is the other of 2, 3
  uint32_t parity = 0;                // bit b: parity of the next phase of full[b] to wait for

  for (int l = 0; l < layers; ++l) {
    const LayerOperands<WT> op = layer_operands(first, rest, l);
    const WT* w = op.w;
    const WT* u = op.u;
    const float* b = op.b;
    const float* sw = op.sw;
    const float* su = op.su;
    float* out = (layers - 1 - l) % 2 == 0 ? hs : seq_ws;
    const float* in = l == 0 ? x : (out == hs ? seq_ws : hs);
    const int d = l == 0 ? d_in : hidden;
    const bool x_vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
    float* hn_l = hn + (long long)l * batch * hidden;
    float* cn_l = cn + (long long)l * batch * hidden;

    // u's slice, interleaved: row k, unit jj gathers u[k][gi H + rank hc + jj]
    if constexpr (sizeof(WT) == 4) {
      for (int e = tid; e < hidden * g4; e += blockDim.x) {
        const int k = e / g4, c = e - k * g4;
        const WT* from = u + (long long)k * gates + (c & 3) * hidden + rank * hc + c / 4;
        __pipeline_memcpy_async(u_s + e, from, 4);
      }
    } else {  // bytes: gathered into registers eight units at a time, then stored four gates a word
      constexpr int kBatch = 8;
      for (int e0 = tid; e0 < hidden * hc; e0 += kBatch * blockDim.x) {
        uint32_t quad[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int e = e0 + i * blockDim.x;
          quad[i] = 0;
          if (e < hidden * hc) {
            const int k = e / hc;
            const uint8_t* src = reinterpret_cast<const uint8_t*>(u) + (long long)k * gates +
                                 rank * hc + (e - k * hc);
            quad[i] = src[0] | (uint32_t(src[hidden]) << 8) | (uint32_t(src[2 * hidden]) << 16) |
                      (uint32_t(src[3 * hidden]) << 24);
          }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int e = e0 + i * blockDim.x;
          if (e < hidden * hc) reinterpret_cast<uint32_t*>(u_s)[e] = quad[i];
        }
      }
    }
    __pipeline_commit();
    for (int e = tid; e < bb * hidden; e += blockDim.x) h0[e] = 0.0f;
    for (int e = tid; e < bb * hc; e += blockDim.x) c_s[e] = 0.0f;
    if (l == 0 && tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(full0) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(full1) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __pipeline_wait_prior(0);
    // Every block of the cluster is running (layer 0: with its mbarriers set
    // up) and has its step-0 h zeroed, and has finished layer l - 1, before
    // any block stores into another's shared memory or reads `in`.
    cluster.sync();

    for (int t = 0; t < seq; ++t) {
      const int tt = t % chunk;
      if (tt == 0) {  // the input projection of the next `chunk` steps
        project_inputs<WT>(in, w, b, sw, zx, scratch, b0, bb, t, min(chunk, seq - t), seq, d,
                           hidden, hc, g4, rank, lane, lanes, c4, col, x_vec);
      }
      // h[t-1], stored into buffer t % 2 at step t - 1, is complete.
      if (t > 0) {
        const int buf = t & 1;
        wait_phase(buf ? full1 : full0, (parity >> buf) & 1);
        parity ^= 1u << buf;
      }
      // Phase 1: partial sums of h[t-1]·u over the thread's k-slice.
      const float* h_cur = (t & 1) ? h1 : h0;
      float* h_next = (t & 1) ? h0 : h1;
      const uint32_t full_next = (t & 1) ? full0 : full1;
      if (tid == 0 && t + 1 < seq) expect_bytes(full_next, bytes_in);
      if (lane < lanes) {
        for (int r0 = 0; r0 < bb; r0 += R) {
          float4 acc[R];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          dot_quads<WT, R>(h_cur, hidden, r0, bb, u_s + c4, g4, k0, k1, acc);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            if (r0 + i < bb) {
              *reinterpret_cast<float4*>(scratch + (long long)(lane * bb + r0 + i) * g4 + c4) =
                  acc[i];
            }
          }
        }
      }
      __syncthreads();  // partial sums (and, at a chunk's first step, zx) complete
      // Phase 2, one thread per (row, unit) of the block: its four gates
      // z = (x·w + b) + h·u (int8: each product times its scale) and their
      // activations, then c and h; h goes to every block's next h buffer.
      const bool last = t + 1 == seq;
      for (int e = tid; e < bb * hc; e += blockDim.x) {
        const int r = e / hc, jj = e - r * hc, j = rank * hc + jj;
        const float4* part = reinterpret_cast<const float4*>(scratch + r * g4 + 4 * jj);
        const int stride = bb * hc;  // float4s between two slices' partial sums
        float4 zu = make_float4(0.0f, 0.0f, 0.0f, 0.0f), zv = zu;
        int s = 0;
        for (; s + 2 <= lanes; s += 2) {  // two chains, so that loads overlap
          const float4 a = part[s * stride], b2 = part[(s + 1) * stride];
          zu = make_float4(zu.x + a.x, zu.y + a.y, zu.z + a.z, zu.w + a.w);
          zv = make_float4(zv.x + b2.x, zv.y + b2.y, zv.z + b2.z, zv.w + b2.w);
        }
        if (s < lanes) {
          const float4 a = part[s * stride];
          zu = make_float4(zu.x + a.x, zu.y + a.y, zu.z + a.z, zu.w + a.w);
        }
        zu = make_float4(zu.x + zv.x, zu.y + zv.y, zu.z + zv.z, zu.w + zv.w);
        if constexpr (sizeof(WT) == 1) {
          zu = make_float4(__fmul_rn(zu.x, su[j]), __fmul_rn(zu.y, su[hidden + j]),
                           __fmul_rn(zu.z, su[2 * hidden + j]),
                           __fmul_rn(zu.w, su[3 * hidden + j]));
        }
        const float4 zxv = *reinterpret_cast<const float4*>(zx + (tt * bb + r) * g4 + 4 * jj);
        const float act[4] = {
            apply_variant(__fadd_rn(zxv.x, zu.x), impl, kSigmoid, table_s),
            apply_variant(__fadd_rn(zxv.y, zu.y), impl, kSigmoid, table_s),
            apply_variant(__fadd_rn(zxv.z, zu.z), impl, gate_g == 2 ? kTanh : kSigmoid, table_s),
            apply_variant(__fadd_rn(zxv.w, zu.w), impl, gate_g == 3 ? kTanh : kSigmoid, table_s)};
        const float g = packed ? act[3] : act[2], o = packed ? act[2] : act[3];
        const float c = act[1] * c_s[e] + act[0] * g;
        const float h = o * apply_variant(c, impl, kTanh, table_s);
        c_s[e] = c;
        h_next[r * hidden + j] = h;
        if (!last) {
          const uint32_t at = smem_addr(h_next + r * hidden + j);
          for (int p = 0; p < csize; ++p) {
            if (p != rank) push_value(cluster_addr(at, p), h, cluster_addr(full_next, p));
          }
        }
        out[((long long)(b0 + r) * seq + t) * hidden + j] = h;
        if (last) {
          hn_l[(long long)(b0 + r) * hidden + j] = h;
          cn_l[(long long)(b0 + r) * hidden + j] = c;
        }
      }
      __syncthreads();  // the block's own h[t] is visible, and the partial sums consumed
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
template <typename WT, int R>
int launch_seq(const void* x, const void* w, const void* u, const void* b, const void* sw,
               const void* su, const void* table, void* hs, void* hn, void* cn, int batch,
               int seq, int d_in, int hidden, int impl, int packed, int block_b, int resident,
               int smem, cudaStream_t s) {
  static int smem_set[kMaxDevices] = {};
  const int rc = allow_smem(lstm_seq_kernel<WT, R>, smem, smem_set);
  if (rc != 0) return rc;
  const int blocks = (batch + block_b - 1) / block_b;
  lstm_seq_kernel<WT, R><<<blocks, lstm_block_threads(hidden), smem, s>>>(
      (const float*)x, (const WT*)w, (const WT*)u, (const float*)b, (const float*)sw,
      (const float*)su, (const float*)table, (float*)hs, (float*)hn, (float*)cn, batch, seq,
      d_in, hidden, impl, packed, block_b, resident);
  return static_cast<int>(cudaGetLastError());
}

// The shared-memory attribute of the cluster kernel, once per instantiation,
// device and size.
template <typename WT, int R>
int prepare_cluster(int smem) {
  static int smem_set[kMaxDevices] = {};
  return allow_smem(lstm_cluster_kernel<WT, R>, smem, smem_set);
}

struct ClusterConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  ClusterConfig(int tiles, int smem, cudaStream_t s) {
    cfg = cudaLaunchConfig_t{};
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(tiles * kCluster);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Layer 0's operands as the kernels take them.
template <typename WT>
LayerOperands<WT> first_layer(const void* w, const void* u, const void* b, const void* sw,
                              const void* su) {
  return {static_cast<const WT*>(w), static_cast<const WT*>(u), static_cast<const float*>(b),
          static_cast<const float*>(sw), static_cast<const float*>(su)};
}

// The cluster path for `layers` >= 1 layers (rest and seq_ws unused at 1).
template <typename WT, int R>
int launch_cluster(const void* x, const void* w0, const void* u0, const void* b0,
                   const void* sw0, const void* su0, const void* rest, const void* table,
                   void* hs, void* seq_ws,
                   void* hn, void* cn, int batch, int seq, int d_in, int hidden, int layers,
                   int impl, int packed, int block_b, int chunk, int smem, cudaStream_t s) {
  const int rc = prepare_cluster<WT, R>(smem);
  if (rc != 0) return rc;
  ClusterConfig launch((batch + block_b - 1) / block_b, smem, s);
  const cudaError_t e = cudaLaunchKernelEx(
      &launch.cfg, lstm_cluster_kernel<WT, R>, (const float*)x,
      first_layer<WT>(w0, u0, b0, sw0, su0), (const long long*)rest, (const float*)table,
      (float*)hs, (float*)seq_ws, (float*)hn, (float*)cn, batch, seq, d_in, hidden, layers, impl,
      packed, block_b, chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the kernel fit on the card at once; a negative CUDA
// error if the query fails.
template <typename WT, int R>
int cluster_occupancy(int smem) {
  const int rc = prepare_cluster<WT, R>(smem);
  if (rc != 0) return -rc;
  ClusterConfig query(1, smem, nullptr);
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(lstm_cluster_kernel<WT, R>), &query.cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

template <typename WT, int R>
int launch_stack(const void* x, const void* w0, const void* u0, const void* b0,
                 const void* sw0, const void* su0, const void* rest, const void* table, void* hs,
                 void* hn,
                 void* cn, int batch, int seq, int d_in, int hidden, int layers, int impl,
                 int packed, int block_b, int resident, int smem, cudaStream_t s) {
  static int smem_set[kMaxDevices] = {};
  const int rc = allow_smem(lstm_stack_kernel<WT, R>, smem, smem_set);
  if (rc != 0) return rc;
  const int blocks = (batch + block_b - 1) / block_b;
  lstm_stack_kernel<WT, R><<<blocks, lstm_block_threads(hidden), smem, s>>>(
      (const float*)x, first_layer<WT>(w0, u0, b0, sw0, su0), (const long long*)rest,
      (const float*)table, (float*)hs, (float*)hn,
      (float*)cn, batch, seq, d_in, hidden, layers, impl, packed, block_b, resident);
  return static_cast<int>(cudaGetLastError());
}

// The cluster path's checks, shared by both entry points: 0 if the geometry
// is one the cluster kernel takes, else -2 (geometry) or -1 (shared memory).
inline int cluster_args_ok(int hidden, int block_b, int chunk, int seq, int quantized,
                           int smem_bytes) {
  if (!cluster_shape_ok(hidden) || chunk < 1 || chunk > seq) return -2;
  const int smem = cluster_smem_bytes(block_b, chunk, hidden, kCluster, quantized ? 1 : 4);
  if (smem != smem_bytes || smem > kMaxSharedBytes) return -1;
  return 0;
}

}  // namespace
}  // namespace repro

#define REPRO_BY_ROWS(CALL, WT)                   \
  switch (repro::rows_in_registers(block_b)) {    \
    case 1: return CALL(WT, 1);                   \
    case 2: return CALL(WT, 2);                   \
    default: return CALL(WT, 4);                  \
  }

#define REPRO_CLUSTER(WT, R)                                                                     \
  launch_cluster<WT, R>(x, w0, u0, b0, sw0, su0, rest, table, hs, seq_ws, hn, cn, batch, seq,   \
                        d_in, hidden, layers, impl, packed, block_b, chunk, smem_bytes, s)

// a = {x, w, u, b, sw, su, table, hs, hn, cn, batch, seq, d_in, hidden, impl,
// quantized, packed, block_b, resident, cluster, chunk, smem_bytes, stream}.
// x: (B, S, D) f32; w: (D, 4H), u: (H, 4H), f32 (quantized == 0) or int8
// (quantized == 1), gate columns i,f,g,o (packed == 0) or i,f,o,g
// (packed == 1); b, sw, su: (4H) f32 (sw and su are read only when
// quantized); hs: (B, S, H); hn, cn: (B, H).  All contiguous.  cluster = 1
// takes paths 1 or 3 (block_b rows a block, weights resident or not);
// cluster = kCluster takes path 2 (block_b rows a cluster, the input projection
// `chunk` steps at a time).  smem_bytes is the caller's figure for one
// block's shared memory; -1 is returned if it is not this file's or exceeds
// a block's limit, -2 for a geometry the kernels do not take.  Otherwise
// returns cudaGetLastError() after the launch.
extern "C" int repro_lstm_seq(const long long* a, int count) {
  using namespace repro;
  if (count != 23) return kBadArgCount;
  const void *x = arg_ptr<const void>(a[0]), *w0 = arg_ptr<const void>(a[1]);
  const void *u0 = arg_ptr<const void>(a[2]), *b0 = arg_ptr<const void>(a[3]);
  const void *sw0 = arg_ptr<const void>(a[4]), *su0 = arg_ptr<const void>(a[5]);
  const void* table = arg_ptr<const void>(a[6]);
  void *hs = arg_ptr<void>(a[7]), *hn = arg_ptr<void>(a[8]), *cn = arg_ptr<void>(a[9]);
  const int batch = static_cast<int>(a[10]), seq = static_cast<int>(a[11]);
  const int d_in = static_cast<int>(a[12]), hidden = static_cast<int>(a[13]);
  const int impl = static_cast<int>(a[14]), quantized = static_cast<int>(a[15]);
  const int packed = static_cast<int>(a[16]), block_b = static_cast<int>(a[17]);
  const int resident = static_cast<int>(a[18]), cluster = static_cast<int>(a[19]);
  const int chunk = static_cast<int>(a[20]), smem_bytes = static_cast<int>(a[21]);
  cudaStream_t s = arg_stream(a[22]);
  if (batch < 1 || seq < 1 || block_b < 1) return -2;
  if (!quantized) {
    sw0 = nullptr;
    su0 = nullptr;
  }
  if (cluster == kCluster) {
    const int rc = cluster_args_ok(hidden, block_b, chunk, seq, quantized, smem_bytes);
    if (rc != 0) return rc;
    const void* rest = nullptr;
    void* seq_ws = nullptr;
    const int layers = 1;
    if (quantized) {
      REPRO_BY_ROWS(REPRO_CLUSTER, int8_t)
    } else {
      REPRO_BY_ROWS(REPRO_CLUSTER, float)
    }
  }
  if (cluster != 1) return -2;
  const int smem = seq_smem_bytes(block_b, seq, d_in, hidden, 1, quantized ? 1 : 4, resident);
  if (smem != smem_bytes || smem > kMaxSharedBytes) return -1;
#define REPRO_SEQ(WT, R)                                                                       \
  launch_seq<WT, R>(x, w0, u0, b0, sw0, su0, table, hs, hn, cn, batch, seq, d_in, hidden,     \
                    impl, packed, block_b, resident, smem, s)
  if (quantized) {
    REPRO_BY_ROWS(REPRO_SEQ, int8_t)
  } else {
    REPRO_BY_ROWS(REPRO_SEQ, float)
  }
#undef REPRO_SEQ
}

// a = {quantized, block_b, smem_bytes}: how many clusters of the cluster
// kernel, as repro_lstm_seq or repro_lstm_stack would launch it with these
// arguments, the current device holds at once
// (cudaOccupancyMaxActiveClusters); a negative CUDA error if the query fails.
extern "C" int repro_lstm_seq_cluster_occupancy(const long long* a, int count) {
  using namespace repro;
  if (count != 3) return kBadArgCount;
  const int quantized = static_cast<int>(a[0]), block_b = static_cast<int>(a[1]);
  const int smem = static_cast<int>(a[2]);
  if (block_b < 1 || smem > kMaxSharedBytes) return -2;
#define REPRO_OCCUPANCY(WT, R) cluster_occupancy<WT, R>(smem)
  if (quantized) {
    REPRO_BY_ROWS(REPRO_OCCUPANCY, int8_t)
  } else {
    REPRO_BY_ROWS(REPRO_OCCUPANCY, float)
  }
#undef REPRO_OCCUPANCY
}

// a = {x, w0, u0, b0, sw0, su0, rest, table, hs, seq_ws, hn, cn, batch, seq,
// d_in, hidden, layers, impl, quantized, packed, block_b, resident, cluster,
// chunk, smem_bytes, stream}: as repro_lstm_seq for `layers` >= 2 layers.
// w0, u0, b0, sw0, su0: layer 0's operands, w0 (D, 4H); rest: a device
// int64 table (L-1, 5) of the addresses of the other layers' w (H, 4H), u,
// b, sw, su (0 for absent scales); hn, cn: (L, B, H).  seq_ws: a (B, S, H) f32 workspace for the cluster
// path's inter-layer sequence, 16-byte aligned as hs (cluster = kCluster;
// unused by paths 1 and 3).
extern "C" int repro_lstm_stack(const long long* a, int count) {
  using namespace repro;
  if (count != 26) return kBadArgCount;
  const void *x = arg_ptr<const void>(a[0]), *w0 = arg_ptr<const void>(a[1]);
  const void *u0 = arg_ptr<const void>(a[2]), *b0 = arg_ptr<const void>(a[3]);
  const void *sw0 = arg_ptr<const void>(a[4]), *su0 = arg_ptr<const void>(a[5]);
  const void *rest = arg_ptr<const void>(a[6]), *table = arg_ptr<const void>(a[7]);
  void *hs = arg_ptr<void>(a[8]), *seq_ws = arg_ptr<void>(a[9]);
  void *hn = arg_ptr<void>(a[10]), *cn = arg_ptr<void>(a[11]);
  const int batch = static_cast<int>(a[12]), seq = static_cast<int>(a[13]);
  const int d_in = static_cast<int>(a[14]), hidden = static_cast<int>(a[15]);
  const int layers = static_cast<int>(a[16]), impl = static_cast<int>(a[17]);
  const int quantized = static_cast<int>(a[18]), packed = static_cast<int>(a[19]);
  const int block_b = static_cast<int>(a[20]), resident = static_cast<int>(a[21]);
  const int cluster = static_cast<int>(a[22]), chunk = static_cast<int>(a[23]);
  const int smem_bytes = static_cast<int>(a[24]);
  cudaStream_t s = arg_stream(a[25]);
  if (layers < 2 || batch < 1 || seq < 1 || block_b < 1 || rest == nullptr) return -2;
  if (!quantized) {
    sw0 = nullptr;
    su0 = nullptr;
  }
  if (cluster == kCluster) {
    const int rc = cluster_args_ok(hidden, block_b, chunk, seq, quantized, smem_bytes);
    if (rc != 0) return rc;
    // layers after the first read hs or seq_ws in 16-byte cp.async.cg copies
    if (seq_ws == nullptr || (reinterpret_cast<uintptr_t>(hs) | reinterpret_cast<uintptr_t>(seq_ws)) % 16)
      return -2;
    if (quantized) {
      REPRO_BY_ROWS(REPRO_CLUSTER, int8_t)
    } else {
      REPRO_BY_ROWS(REPRO_CLUSTER, float)
    }
  }
  if (cluster != 1) return -2;
  const int smem =
      seq_smem_bytes(block_b, seq, d_in, hidden, layers, quantized ? 1 : 4, resident);
  if (smem != smem_bytes || smem > kMaxSharedBytes) return -1;
#define REPRO_STACK(WT, R)                                                                     \
  launch_stack<WT, R>(x, w0, u0, b0, sw0, su0, rest, table, hs, hn, cn, batch, seq, d_in,      \
                      hidden, layers, impl, packed, block_b, resident, smem, s)
  if (quantized) {
    REPRO_BY_ROWS(REPRO_STACK, int8_t)
  } else {
    REPRO_BY_ROWS(REPRO_STACK, float)
  }
#undef REPRO_STACK
}
