"""Fused LSTM cell: one step, one CUDA launch.

All four gate pre-activations come from one pass over the (D, 4H) and
(H, 4H) weights inside the kernel (``csrc/lstm_cell.cu``), with the gate
nonlinearities in the same kernel's epilogue, so nothing travels through
device memory between the products and the activations.

This is the SINGLE-STEP kernel: driving it from a Python loop launches once
per timestep and re-reads the weights every launch.
``repro_torch.kernels.lstm_seq`` runs the whole recurrence in one launch;
this cell remains the decode-style primitive and the per-step baseline the
benchmarks compare against.

:func:`lstm_cell_plain` is the plain PyTorch version of the kernel's
arithmetic (gate order i,f,g,o; tanh as 2σ(2x) − 1), taken only for CPU
tensors.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.activations import apply_variant_plain, impl_code, table_pointer
from repro_torch.models.activations import LUT_SIZE


K_SLICES = 4  # k-slices of the gates' partial sums; `kSlices` in csrc/lstm_common.cuh


def cell_smem_bytes(bb: int, d_in: int, hidden: int) -> int:
    """One block's shared memory: table | x tile | h tile | the gates' partial
    sums, one (bb, 4H) slice per k-slice; f32 (``cell_smem_floats`` in
    ``csrc/lstm_cell.cu``)."""
    r4 = lambda n: runtime.round_up(n, 4)
    return 4 * (LUT_SIZE + r4(bb * d_in) + r4(bb * hidden) + K_SLICES * bb * 4 * hidden)


def lstm_cell_plain(x, h, c, w, u, b, *, impl: str = "exact"):
    """Plain PyTorch version of the kernel."""
    hidden = h.shape[1]
    z = (x @ w + b[None, :]) + h @ u
    i = apply_variant_plain(z[:, :hidden], impl, "sigmoid")
    f = apply_variant_plain(z[:, hidden : 2 * hidden], impl, "sigmoid")
    g = apply_variant_plain(z[:, 2 * hidden : 3 * hidden], impl, "tanh")
    o = apply_variant_plain(z[:, 3 * hidden :], impl, "sigmoid")
    c_new = f * c + i * g
    h_new = o * apply_variant_plain(c_new, impl, "tanh")
    return h_new, c_new


_OPERANDS = ("x", "h", "c", "w", "u", "b")


def lstm_cell_fused(x, h, c, w, u, b, *, impl: str = "exact", block_b: int | str = "auto"):
    """x: (B, D); h/c: (B, H); w: (D, 4H); u: (H, 4H); b: (4H,); all f32
    (anything else raises).  Returns (h', c').

    ``block_b`` is the batch tile of one thread block; ``"auto"`` follows
    the fixed rule of :func:`runtime.pick_block_b`.
    """
    code = impl_code(impl)
    runtime.require_dtype("lstm_cell", torch.float32, _OPERANDS, x, h, c, w, u, b)
    bsz, d_in = x.shape
    hidden = h.shape[1]
    if (h.shape != (bsz, hidden) or c.shape != (bsz, hidden) or w.shape != (d_in, 4 * hidden)
            or u.shape != (hidden, 4 * hidden) or b.shape != (4 * hidden,)):
        raise ValueError(
            f"lstm_cell: inconsistent shapes x {tuple(x.shape)} h {tuple(h.shape)} "
            f"c {tuple(c.shape)} w {tuple(w.shape)} u {tuple(u.shape)} b {tuple(b.shape)}"
        )
    dev = runtime.require_same_device(x, h, c, w, u, b)
    bb, smem = _cell_plan(block_b, bsz, d_in, hidden)
    if dev.type == "cpu":
        return lstm_cell_plain(x, h, c, w, u, b, impl=impl)
    ptrs = runtime.aligned_pointers("lstm_cell", _OPERANDS, x, h, c, w, u, b)
    h_new = torch.empty_like(h)
    c_new = torch.empty_like(c)
    runtime.launch("lstm_cell", "repro_lstm_cell", dev.index, *ptrs, table_pointer(dev, code),
                   h_new.data_ptr(), c_new.data_ptr(), bsz, d_in, hidden, code, bb, smem)
    return h_new, c_new


@functools.lru_cache(maxsize=1024)
def _cell_plan(block_b, bsz: int, d_in: int, hidden: int) -> tuple[int, int]:
    """Batch tile and shared memory of one block."""
    bb = runtime.pick_block_b(block_b, bsz, lambda n: cell_smem_bytes(n, d_in, hidden),
                              "lstm_cell")
    return bb, cell_smem_bytes(bb, d_in, hidden)
