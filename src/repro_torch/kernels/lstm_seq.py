"""Sequence LSTM — the whole recurrence in ONE CUDA launch.

The paper's C1/C2 headline comes from keeping the LSTM weights on chip and
running all four gates through one MAC array, so each timestep pays for
compute and never for re-streaming weights or state.
``lstm_cell.lstm_cell_fused`` ports the *cell* but is launched once per
timestep from a Python loop.  The kernels here (``csrc/lstm_seq.cu``) port
the *residency*:

  * the grid walks batch tiles only; the time loop runs INSIDE the kernel,
    so there is one launch per call, and ``h``/``c`` live in shared memory
    for the whole sequence;
  * both products, ``x[t] @ w`` and ``h @ u``, are computed in the kernel.
    f32 weights are read in the public gate order i,f,g,o as they are: the
    order only decides which H columns get the tanh, so nothing is permuted
    per call.  Quantized weights are stored PACKED [i, f, o, g]
    (``kernels.lstm_quant``) and the kernel is told so;
  * ``x`` is read, and ``hs`` written, in the public batch-major layout:
    the wrapper makes no time-major copy and pads nothing, the ragged last
    tile simply has fewer rows.

Where the weights live (:func:`plan_launch` chooses and reports it; one
layer and a stack take the same three paths):

  * **one block per batch tile, weights resident**: if one layer's ``w``
    and ``u`` fit in a thread block's shared memory beside the tile's
    state, the block copies them in once (a stack: once per layer) and
    every step reads them there (the paper's shape, the small bench
    widths);
  * **a thread-block cluster per batch tile**: where they do not (D = H =
    256, f32 or int8), a cluster of ``CLUSTER`` = 8 blocks splits the H
    hidden units, each block keeping its (H, 4H/8) slice of ``u`` in shared
    memory; the input projection ``x·w + b`` is computed ahead of the
    recurrence (as the JAX kernel's ``_input_projection`` does), and each
    step's h is exchanged through distributed shared memory.  A stack runs
    its layers one after another in the same clusters, each layer loading
    its slice of ``u`` and projecting the previous layer's h sequence;
  * **weights re-read from L2 each step**: where no cluster's slice fits
    either, or H does not split over 8 blocks.

**int8 weights** (``lstm_seq_fused_q8`` / ``lstm_seq_fused_quantized``):
``w``/``u`` as int8 with per-gate-column f32 scales (``kernels.lstm_quant``),
converted at the load; the scale multiplies the finished sum.

**layer-fused stacks** (``lstm_stack_fused``): L layers in one launch.  On
the block and L2 paths the inter-layer h sequence lives in a (S, bb, H) f32
shared-memory buffer, written by layer l and read, row by row, by layer
l+1; when that buffer cannot fit even for one batch row the wrapper raises
a ``ValueError`` stating the bound.  On the cluster path it goes through a
(B, S, H) f32 workspace in device memory that the wrapper allocates (it
stays in L2), since a block cannot hold all S steps of its rows beside its
slice of ``u``; layers alternate between it and ``hs`` so that the last
writes ``hs``.

Each kernel has its plain PyTorch version here (:func:`lstm_seq_plain`,
:func:`lstm_stack_plain`), taken only for CPU tensors.

``block_b`` is the batch tile of one thread block, or of one cluster on the
cluster path: an int is honoured or refused with a ``ValueError`` that
states the bound; ``"auto"`` is the block-size tuner's pick
(``kernels.autotune``), resolved once per shape by :func:`plan_launch`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.activations import apply_variant_plain, impl_code, table_pointer
from repro_torch.models.activations import LUT_SIZE


@functools.lru_cache(maxsize=None)
def _ifog_index(hidden: int, device: torch.device) -> torch.Tensor:
    idx = torch.arange(4 * hidden)
    return torch.cat([idx[: 2 * hidden], idx[3 * hidden :], idx[2 * hidden : 3 * hidden]]).to(device)


def _pack_ifog(w, u, b, hidden: int):
    """Permute gate columns i,f,g,o → i,f,o,g: the stored layout of
    quantized weights (``kernels.lstm_quant``), as in the reference.  One
    gather per tensor, with the column index cached per (H, device)."""
    idx = _ifog_index(hidden, w.device)
    return w.index_select(-1, idx), u.index_select(-1, idx), b.index_select(-1, idx)


# ---------------------------------------------------------------------------
# Launch geometry
# ---------------------------------------------------------------------------
K_SLICES = 4  # k-slices of the block paths' partial sums; `kSlices` in csrc/lstm_common.cuh


def seq_smem_bytes(bb: int, seq: int, d_in: int, hidden: int, layers: int,
                   wbytes: int, resident: bool) -> int:
    """One block's shared memory (``seq_smem_bytes`` in ``csrc/lstm_seq.cu``):
    f32 table | h | c | the gates' partial sums, one (bb, 4H) slice per
    k-slice | two x[t] tiles | the (S, bb, H) inter-layer sequence
    for a stack, then one layer's ``w`` and ``u`` at ``wbytes`` per element
    when they are resident."""
    r4 = lambda n: runtime.round_up(n, 4)
    floats = LUT_SIZE + 2 * r4(bb * hidden) + K_SLICES * bb * 4 * hidden + 2 * r4(bb * d_in)
    if layers > 1:
        floats += r4(seq * bb * hidden)
    nbytes = 4 * floats
    if resident:
        w_rows = hidden if (layers > 1 and hidden > d_in) else d_in
        nbytes += runtime.round_up(w_rows * 4 * hidden * wbytes, 16)
        nbytes += runtime.round_up(hidden * 4 * hidden * wbytes, 16)
    return nbytes


# The cluster path; the names in brackets are csrc/lstm_seq.cu's.
CLUSTER = 8                    # blocks a cluster [kCluster]: the most sm_90 allows portably,
                               # and the size measured fastest at D = H = 256 (PERF.md)
CLUSTER_THREADS = 256          # threads of a cluster block [kClusterThreads]
PROJ_ROWS, PROJ_K = 12, 16     # the input projection's row and k tiles [kProjRows, kProjK]
BARRIER_BYTES = 16             # a cluster block's two mbarriers [kBarrierBytes]


def cluster_shape_ok(hidden: int) -> bool:
    """A cluster can split ``hidden`` units: whole quads of units per
    block, and no more column quads than threads."""
    return hidden % (4 * CLUSTER) == 0 and hidden // CLUSTER <= CLUSTER_THREADS


def cluster_smem_bytes(bb: int, chunk: int, hidden: int, wbytes: int) -> int:
    """One cluster block's shared memory (``cluster_smem_bytes`` in
    ``csrc/lstm_seq.cu``): two mbarriers, then f32 table | h, two (bb, H)
    buffers | c (bb, H/C) | scratch (a step's partial sums, or the
    projection's two stage buffers of x rows and w rows) | zx (chunk, bb,
    4H/C), then the (H, 4H/C) slice of ``u`` at ``wbytes`` per element."""
    r4 = lambda n: runtime.round_up(n, 4)
    hc = hidden // CLUSTER
    lanes = CLUSTER_THREADS // hc
    stage = lanes * PROJ_ROWS * PROJ_K + PROJ_K * 4 * hc * wbytes // 4
    scratch = max(lanes * bb * 4 * hc, 2 * stage)
    floats = LUT_SIZE + 2 * r4(bb * hidden) + r4(bb * hc) + scratch + chunk * bb * 4 * hc
    return BARRIER_BYTES + 4 * floats + runtime.round_up(hidden * 4 * hc * wbytes, 16)


@functools.lru_cache(maxsize=None)
def cluster_slots(device: torch.device) -> int | None:
    """Clusters the card ``device`` runs at once at one block an SM
    (``cudaOccupancyMaxActiveClusters`` for the cluster kernel at a block's
    whole shared memory; 15 on an H100 SXM), asked once per device; None
    for the CPU."""
    if device.type != "cuda":
        return None
    with torch.cuda.device(device):
        slots = runtime.query("repro_lstm_seq_cluster_occupancy", 0, 1,
                              runtime.MAX_SHARED_BYTES)
    if slots < 1:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed on {device} (code {slots})")
    return slots


class LaunchPlan(NamedTuple):
    block_b: int      # batch rows per thread block, or per cluster when cluster > 1
    resident: bool    # weights (u's slices on the cluster path) kept in shared memory
    smem_bytes: int   # dynamic shared memory of one block
    cluster: int = 1  # blocks per cluster; 1: no cluster
    clusters: int = 1  # batch tiles: clusters, or blocks when cluster == 1
    chunk: int = 0    # steps of input projection held at once (cluster path)

    @property
    def path(self) -> str:
        """"block" (weights resident in one block), "cluster" or "l2"."""
        if self.cluster > 1:
            return "cluster"
        return "block" if self.resident else "l2"


def _cluster_plan(bb: int, batch: int, seq: int, hidden: int, wbytes: int):
    """The cluster path at ``bb`` rows a cluster (clipped to the batch), or
    None where a cluster block cannot hold them.  The projection holds as
    many steps as fit, all S if they do."""
    bb = min(bb, batch)
    need = cluster_smem_bytes(bb, 1, hidden, wbytes)
    if need > runtime.MAX_SHARED_BYTES:
        return None
    per_step = cluster_smem_bytes(bb, 2, hidden, wbytes) - need
    chunk = min(seq, 1 + (runtime.MAX_SHARED_BYTES - need) // per_step)
    smem = cluster_smem_bytes(bb, chunk, hidden, wbytes)
    return LaunchPlan(bb, True, smem, CLUSTER, -(-batch // bb), chunk)


def _check_block_b(block_b, kernel: str) -> None:
    if block_b != "auto" and (isinstance(block_b, bool) or not isinstance(block_b, int)
                              or block_b < 1):
        raise ValueError(f"{kernel}: block_b must be a positive int or 'auto', got {block_b!r}")


@functools.lru_cache(maxsize=4096)
def plan_for(block_b: int, batch: int, seq: int, d_in: int, hidden: int, *,
             layers: int = 1, quantized: bool = False) -> LaunchPlan:
    """Path and shared memory of a launch at ``block_b`` rows a block (or a
    cluster), honoured or refused with a ``ValueError`` that states the
    bound.  One block per tile with the weights resident if they fit;
    else, where H splits over ``CLUSTER`` blocks, a cluster per tile, if its
    blocks can hold their rows beside their slice of ``u`` (one layer or a
    stack alike); else the weights are re-read from L2 each step.  A stack
    off the cluster path also raises when its rows' inter-layer sequence
    (S·H·4 bytes a row) does not fit."""
    wbytes = 1 if quantized else 4
    kernel = "lstm_stack" if layers > 1 else "lstm_seq"
    _check_block_b(block_b, kernel)
    if block_b == "auto":
        raise ValueError(f"{kernel}: plan_for takes rows; plan_launch resolves 'auto'")
    try:
        bb = runtime.pick_block_b(
            block_b, batch,
            lambda n: seq_smem_bytes(n, seq, d_in, hidden, layers, wbytes, False), kernel,
        )
    except ValueError as err:
        refused, bb = err, None
    if bb is not None:
        with_weights = seq_smem_bytes(bb, seq, d_in, hidden, layers, wbytes, True)
        if with_weights <= runtime.MAX_SHARED_BYTES:
            return LaunchPlan(bb, True, with_weights, 1, -(-batch // bb))
    if cluster_shape_ok(hidden):
        plan = _cluster_plan(block_b, batch, seq, hidden, wbytes)
        if plan is not None:
            return plan
    if bb is None:
        raise refused
    return LaunchPlan(bb, False, seq_smem_bytes(bb, seq, d_in, hidden, layers, wbytes, False),
                      1, -(-batch // bb))


@functools.lru_cache(maxsize=1024)
def plan_launch(block_b, batch: int, seq: int, d_in: int, hidden: int, *,
                layers: int = 1, quantized: bool = False, slots: int | None = None,
                backend: str = "cpu") -> LaunchPlan:
    """Path, batch tile and shared memory of one launch (:func:`plan_for`).

    ``"auto"`` takes the rows from the block-size tuner
    (``kernels.autotune``, kernel ``lstm_seq`` or ``lstm_stack``), which
    weighs the waves of tiles the card runs against the per-step latency
    of the rows each carries; ``slots`` is the card's
    :func:`cluster_slots` (the wrappers pass it; None means the tuner's
    chip model, 15 on an H100 SXM) and ``backend`` the tuner's cache key.
    Memoized per shape, so the tuner is asked once per shape and never
    from inside a CUDA graph capture that follows a warm-up."""
    kernel = "lstm_stack" if layers > 1 else "lstm_seq"
    _check_block_b(block_b, kernel)
    if block_b == "auto":
        from repro_torch.kernels import autotune

        problem = {"batch": batch, "seq": seq, "d_in": d_in, "hidden": hidden}
        if layers > 1:
            problem["layers"] = layers
        block_b = autotune.autotune(kernel, problem, dtype="int8" if quantized else "float32",
                                    backend=backend, chip=autotune.chip_with_slots(slots))["block_b"]
    return plan_for(block_b, batch, seq, d_in, hidden, layers=layers, quantized=quantized)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels' arithmetic
# ---------------------------------------------------------------------------
def lstm_seq_plain(x, w, u, b, sw=None, su=None, *, impl: str = "exact", packed: bool = True):
    """One layer, f32 or int8 weights (then ``sw``, ``su`` are the per-column
    scales, applied after each product), gate columns [i, f, o, g] if
    ``packed`` else [i, f, g, o].  x: (B, S, D) → hs (B, S, H), hn, cn (B, H)."""
    bsz, seq, _ = x.shape
    hidden = u.shape[0]
    g_at, o_at = (3 * hidden, 2 * hidden) if packed else (2 * hidden, 3 * hidden)
    wf, uf = w.to(torch.float32), u.to(torch.float32)
    h = torch.zeros((bsz, hidden), dtype=torch.float32, device=x.device)
    c = torch.zeros((bsz, hidden), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(seq):
        zx = x[:, t] @ wf
        zu = h @ uf
        if sw is not None:
            zx = zx * sw[None, :]
            zu = zu * su[None, :]
        z = (zx + b[None, :]) + zu
        i = apply_variant_plain(z[:, :hidden], impl, "sigmoid")
        f = apply_variant_plain(z[:, hidden : 2 * hidden], impl, "sigmoid")
        o = apply_variant_plain(z[:, o_at : o_at + hidden], impl, "sigmoid")
        g = apply_variant_plain(z[:, g_at : g_at + hidden], impl, "tanh")
        c = f * c + i * g
        h = o * apply_variant_plain(c, impl, "tanh")
        hs.append(h)
    return torch.stack(hs, dim=1), h, c


def lstm_stack_plain(x, layers, *, impl: str = "exact", packed: bool = True):
    """L >= 2 layers, each ``(w, u, b, sw, su)`` as the kernel takes them
    (``sw``, ``su`` None for f32 weights).  Returns the last layer's hs
    (B, S, H) and hn, cn (L, B, H)."""
    h = x
    hns, cns = [], []
    for w, u, b, sw, su in layers:
        h, hn, cn = lstm_seq_plain(h, w, u, b, sw, su, impl=impl, packed=packed)
        hns.append(hn)
        cns.append(cn)
    return h, torch.stack(hns), torch.stack(cns)


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------
_SEQ_F32 = ("w", "u", "b")
_SEQ_Q8 = ("w", "u", "b", "w_scale", "u_scale")


def _lstm_seq_call(x, w, u, b, sw, su, *, impl: str, block_b, return_state: bool,
                   packed: bool = False):
    """Shared single-layer launcher. ``sw``/``su`` None → f32 weights in the
    public gate order; int8 weights arrive packed from ``lstm_quant`` and
    are not packed a second time."""
    code = impl_code(impl)
    quantized = sw is not None
    kernel = "lstm_seq_q8" if quantized else "lstm_seq_f32"
    f32 = torch.float32
    if quantized:
        runtime.require_dtype(kernel, f32, ("x", "b", "w_scale", "u_scale"), x, b, sw, su)
        runtime.require_dtype(kernel, torch.int8, ("w", "u"), w, u)
    else:
        runtime.require_dtype(kernel, f32, ("x", "w", "u", "b"), x, w, u, b)
    if x.dim() != 3:
        raise ValueError(f"{kernel}: x must be (B, S, D), got {tuple(x.shape)}")
    bsz, seq, d_in = x.shape
    hidden = u.shape[0]
    if w.shape != (d_in, 4 * hidden) or u.shape != (hidden, 4 * hidden) or b.shape != (4 * hidden,):
        raise ValueError(
            f"{kernel}: inconsistent shapes x {tuple(x.shape)} w {tuple(w.shape)} "
            f"u {tuple(u.shape)} b {tuple(b.shape)}"
        )
    if seq < 1:
        raise ValueError(f"{kernel}: empty sequence")
    weights = (w, u, b, sw, su) if quantized else (w, u, b)
    dev = runtime.require_same_device(x, *weights)

    if dev.type == "cpu":
        # refuses an int block_b as the card would
        plan_launch(block_b, bsz, seq, d_in, hidden, quantized=quantized)
        hs, hn, cn = lstm_seq_plain(x, w, u, b, sw, su, impl=impl, packed=packed)
    else:
        x = x.contiguous()  # a slice of a longer sequence is copied, inside the call
        ptrs = runtime.aligned_pointers(kernel, _SEQ_Q8 if quantized else _SEQ_F32, *weights)
        if not quantized:
            ptrs += (0, 0)
        plan = plan_launch(block_b, bsz, seq, d_in, hidden, quantized=quantized,
                           slots=cluster_slots(dev), backend=runtime.CUDA_BACKEND)
        hs = torch.empty((bsz, seq, hidden), dtype=f32, device=dev)
        hn = torch.empty((bsz, hidden), dtype=f32, device=dev)
        cn = torch.empty((bsz, hidden), dtype=f32, device=dev)
        runtime.launch(
            kernel, "repro_lstm_seq", dev.index, x.data_ptr(), *ptrs, table_pointer(dev, code),
            hs.data_ptr(), hn.data_ptr(), cn.data_ptr(), bsz, seq, d_in, hidden, code,
            int(quantized), int(packed), plan.block_b, int(plan.resident), plan.cluster,
            plan.chunk, plan.smem_bytes,
        )
    if return_state:
        return hs, (hn, cn)
    return hs


def lstm_seq_fused(x, w, u, b, *, impl: str = "exact", block_b: int | str = "auto",
                   return_state: bool = False):
    """Whole-sequence fused LSTM. x: (B, S, D); w: (D, 4H); u: (H, 4H);
    b: (4H,); all f32 (anything else raises), public gate order i,f,g,o.

    Returns hs (B, S, H), plus the final (h, c) when ``return_state``.
    Any B and S work.
    """
    return _lstm_seq_call(x, w, u, b, None, None, impl=impl, block_b=block_b,
                          return_state=return_state)


def lstm_seq_fused_quantized(x, qw, *, impl: str = "exact", block_b: int | str = "auto",
                             return_state: bool = False):
    """int8 sequence LSTM over pre-quantized weights.

    ``qw`` is a ``lstm_quant.QuantizedLSTMWeights`` (packed gate layout,
    per-gate-column scales); it is not packed a second time.
    """
    return _lstm_seq_call(x, qw.w_q, qw.u_q, qw.b, qw.w_scale, qw.u_scale, impl=impl,
                          block_b=block_b, return_state=return_state, packed=True)


def lstm_seq_fused_q8(x, w, u, b, *, impl: str = "exact", block_b: int | str = "auto",
                      return_state: bool = False):
    """Convenience wrapper: quantize f32 weights on the fly, then run the
    int8 kernel (deployments should pre-quantize once with
    ``lstm_quant.quantize_lstm_weights`` and call the ``_quantized``
    variant)."""
    from repro_torch.kernels.lstm_quant import quantize_lstm_weights

    return lstm_seq_fused_quantized(
        x, quantize_lstm_weights(w, u, b, u.shape[0]), impl=impl, block_b=block_b,
        return_state=return_state,
    )


@functools.lru_cache(maxsize=256)
def _layer_table(device: torch.device, addresses: tuple[int, ...]) -> torch.Tensor:
    """The addresses of a stack's layers 1..L-1 (w, u, b, sw, su each, 0
    for an absent scale) as an int64 tensor on ``device``: the kernel reads
    them there.  Keyed by the addresses alone, which is safe: the kernel
    reads whatever tensors lie at those addresses when it runs, and the
    caller passed the tensors that lie there now."""
    return torch.tensor(addresses, dtype=torch.int64, device=device)


_STACK_F32 = ("w", "u", "b")
_STACK_Q8 = ("w", "u", "b", "w_scale", "u_scale")


def _lstm_stack_call(x, layers, *, impl: str, block_b, return_state: bool, packed: bool):
    """Layer-fused stack launcher; ``layers``: L >= 2 tuples ``(w, u, b, sw,
    su)``, layer 0's w (D, 4H) and the others' (H, 4H), u (H, 4H), b (4H);
    ``sw``/``su`` the (4H) scales of int8 weights, or None (f32).  Gate
    columns [i, f, o, g] if ``packed`` (quantized weights) else the public
    [i, f, g, o].  Each layer's tensors are passed as they are: nothing is
    stacked per call."""
    code = impl_code(impl)
    quantized = layers[0][3] is not None
    kernel = "lstm_stack_q8" if quantized else "lstm_stack_f32"
    names = _STACK_Q8 if quantized else _STACK_F32
    f32 = torch.float32
    runtime.require_dtype(kernel, f32, ("x",), x)
    if x.dim() != 3:
        raise ValueError(f"{kernel}: x must be (B, S, D), got {tuple(x.shape)}")
    bsz, seq, d_in = x.shape
    hidden = layers[0][1].shape[0]
    gates = 4 * hidden
    if len(layers) < 2:
        raise ValueError(f"{kernel}: a stack has at least 2 layers, got {len(layers)}")
    operands = [op[:len(names)] for op in layers]
    for l, (w, u, *rest) in enumerate(operands):
        if quantized:
            runtime.require_dtype(kernel, torch.int8, names[:2], w, u)
            runtime.require_dtype(kernel, f32, names[2:], *rest)
        else:
            runtime.require_dtype(kernel, f32, names, w, u, *rest)
        if (w.shape != (d_in if l == 0 else hidden, gates) or u.shape != (hidden, gates)
                or any(t.shape != (gates,) for t in rest)):
            raise ValueError(
                f"{kernel}: layer {l}: inconsistent shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                f"u {tuple(u.shape)} " + " ".join(f"{n} {tuple(t.shape)}"
                                                 for n, t in zip(names[2:], rest))
            )
    if seq < 1:
        raise ValueError(f"{kernel}: empty sequence")
    dev = runtime.require_same_device(x, *(t for op in operands for t in op))

    if dev.type == "cpu":
        # refuses what the card would
        plan_launch(block_b, bsz, seq, d_in, hidden, layers=len(layers), quantized=quantized)
        hs, hn, cn = lstm_stack_plain(x, layers, impl=impl, packed=packed)
    else:
        x = x.contiguous()
        pad = [] if quantized else [0, 0]
        ptrs = [runtime.aligned_pointers(kernel, names, *op) + pad for op in operands]
        rest = _layer_table(dev, tuple(p for op in ptrs[1:] for p in op))
        plan = plan_launch(block_b, bsz, seq, d_in, hidden, layers=len(layers),
                           quantized=quantized, slots=cluster_slots(dev),
                           backend=runtime.CUDA_BACKEND)
        hs = torch.empty((bsz, seq, hidden), dtype=f32, device=dev)
        # the cluster path's inter-layer sequence, beside hs
        seq_ws = torch.empty_like(hs) if plan.path == "cluster" else None
        hn = torch.empty((len(layers), bsz, hidden), dtype=f32, device=dev)
        cn = torch.empty((len(layers), bsz, hidden), dtype=f32, device=dev)
        runtime.launch(
            kernel, "repro_lstm_stack", dev.index, x.data_ptr(), *ptrs[0], rest.data_ptr(),
            table_pointer(dev, code), hs.data_ptr(), 0 if seq_ws is None else seq_ws.data_ptr(),
            hn.data_ptr(), cn.data_ptr(), bsz, seq, d_in, hidden, len(layers), code,
            int(quantized), int(packed), plan.block_b, int(plan.resident), plan.cluster,
            plan.chunk, plan.smem_bytes,
        )
    if return_state:
        return hs, (hn, cn)
    return hs


def lstm_stack_fused(x, layers, *, impl: str = "exact", block_b: int | str = "auto",
                     quantized: bool = False, return_state: bool = False):
    """L-layer layer-fused LSTM stack: ONE launch for all layers.

    x: (B, S, D); ``layers`` is a list of (w, u, b) triples (or param
    dicts): layer 0 takes w (D, 4H); layers 1..L-1 take w (H, 4H); every
    layer's u is (H, 4H).  The inter-layer h sequence stays in shared
    memory (block and L2 paths) or in a workspace that stays in L2 (cluster
    path), inside the one launch.  ``quantized=True`` holds every
    layer's w/u as int8 with per-gate-column scales (``kernels.lstm_quant``).

    Returns hs (B, S, H) of the LAST layer, plus per-layer final states
    (h, c) of shape (L, B, H) when ``return_state``.
    """
    triples = [
        (l["w"], l["u"], l["b"]) if isinstance(l, dict) else l for l in layers
    ]
    if not triples:
        raise ValueError("lstm_stack_fused needs at least one layer")
    hidden = triples[0][1].shape[0]
    for w, u, b in triples[1:]:
        if w.shape != (hidden, 4 * hidden) or u.shape != (hidden, 4 * hidden):
            raise ValueError(
                f"stack layers beyond the first must be ({hidden}, {4 * hidden})"
                f"-shaped, got w {tuple(w.shape)} / u {tuple(u.shape)}"
            )

    if len(triples) == 1:  # degenerate stack: the single-layer kernel IS it
        w, u, b = triples[0]
        fn = lstm_seq_fused_q8 if quantized else lstm_seq_fused
        out = fn(x, w, u, b, impl=impl, block_b=block_b, return_state=return_state)
        if return_state:
            hs, (hn, cn) = out
            return hs, (hn[None], cn[None])
        return out

    if quantized:
        from repro_torch.kernels.lstm_quant import quantize_lstm_stack

        operands = [(q.w_q, q.u_q, q.b, q.w_scale, q.u_scale) for q in quantize_lstm_stack(triples)]
    else:
        operands = [(w, u, b, None, None) for w, u, b in triples]
    return _lstm_stack_call(x, operands, impl=impl, block_b=block_b, return_state=return_state,
                            packed=quantized)
