"""Fused LSTM cell: one step, one CUDA launch.

All four gate pre-activations come from one pass over the (D, 4H) and
(H, 4H) weights inside the kernel (``csrc/lstm_cell.cu``), with the gate
nonlinearities in the same kernel's epilogue, so nothing travels through
device memory between the products and the activations.  The grid splits
the hidden units (``UNITS`` a block, the four gate columns of each) as well
as the batch, so each weight is read once per tile of rows (:func:`plan`).

This is the SINGLE-STEP kernel: driving it from a Python loop launches once
per timestep and reads the weights again every launch.
``repro_torch.kernels.lstm_seq`` runs the whole recurrence in one launch;
this cell remains the decode-style primitive and the per-step baseline the
benchmarks compare against.

:func:`lstm_cell_plain` is the plain PyTorch version of the kernel's
arithmetic (gate order i,f,g,o; tanh as 2σ(2x) − 1), taken only for CPU
tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.activations import apply_variant_plain, impl_code, table_pointer
from repro_torch.models.activations import LUT_SIZE


# The kernel's geometry; the names in brackets are csrc/lstm_cell.cu's.
UNITS = 8                    # hidden units a block [kCellUnits]
THREADS = 512                # threads a block [kCellThreads]
ROW_STRIDE = 4 * UNITS + 4   # floats a row of a block's weight slice, padded [kCellStride]


def cell_smem_bytes(rows: int, d_in: int, hidden: int) -> int:
    """One block's shared memory (``cell_smem_floats`` in
    ``csrc/lstm_cell.cu``): f32 table | [x | h] tile (rows, D + H) | the
    block's (D + H, 4 x UNITS) slice of [w; u], rows padded to ROW_STRIDE |
    pre-activations (rows, 4 x UNITS)."""
    k = d_in + hidden
    return 4 * (LUT_SIZE + runtime.round_up(rows * k, 4) + k * ROW_STRIDE + rows * 4 * UNITS)


class CellPlan(NamedTuple):
    units: int                # hidden units a block: j0 .. j0 + units - 1, four gate columns each
    rows: int                 # batch rows a block (``block_b``)
    grid: tuple[int, int]     # (row tiles, unit groups)
    smem_bytes: int           # dynamic shared memory of one block


@functools.lru_cache(maxsize=4096)
def plan_for(block_b: int, batch: int, d_in: int, hidden: int) -> CellPlan:
    """Geometry of one launch at ``block_b`` rows a block, clipped to the
    batch, or a ``ValueError`` that states the bound.  A block owns
    ``UNITS`` hidden units and their four gate columns for a tile of rows,
    so a weight is read once per row tile."""
    if batch < 1:
        raise ValueError("lstm_cell: empty batch")
    if isinstance(block_b, bool) or not isinstance(block_b, int) or block_b < 1:
        raise ValueError(f"lstm_cell: block_b must be a positive int or 'auto', got {block_b!r}")
    rows = min(block_b, batch)
    need = cell_smem_bytes(rows, d_in, hidden)
    if need > runtime.MAX_SHARED_BYTES:
        raise ValueError(
            f"lstm_cell: a tile of {rows} rows needs {need} bytes of shared memory, over the "
            f"{runtime.MAX_SHARED_BYTES} one block may use; pass a smaller block_b"
        )
    return CellPlan(UNITS, rows, (-(-batch // rows), -(-hidden // UNITS)), need)


@functools.lru_cache(maxsize=1024)
def plan(block_b, batch: int, d_in: int, hidden: int, backend: str = "cpu") -> CellPlan:
    """:func:`plan_for`, with ``"auto"`` resolved to the block-size tuner's
    rows (``kernels.autotune``, kernel ``lstm_cell``: the fewest waves of
    blocks, then the fewest rows a block).  Memoized per shape: the tuner is
    asked once per shape; ``backend`` is its cache key's."""
    if block_b == "auto":
        from repro_torch.kernels import autotune

        block_b = autotune.autotune("lstm_cell", {"batch": batch, "d_in": d_in, "hidden": hidden},
                                    dtype="float32", backend=backend)["block_b"]
    return plan_for(block_b, batch, d_in, hidden)


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

    ``block_b`` is the rows of one thread block; ``"auto"`` is the tuner's
    pick (:func:`plan`).
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
    geometry = plan(block_b, bsz, d_in, hidden,
                    runtime.CUDA_BACKEND if dev.type == "cuda" else "cpu")
    if dev.type == "cpu":
        return lstm_cell_plain(x, h, c, w, u, b, impl=impl)
    ptrs = runtime.aligned_pointers("lstm_cell", _OPERANDS, x, h, c, w, u, b)
    h_new = torch.empty_like(h)
    c_new = torch.empty_like(c)
    runtime.launch("lstm_cell", "repro_lstm_cell", dev.index, *ptrs, table_pointer(dev, code),
                   h_new.data_ptr(), c_new.data_ptr(), bsz, d_in, hidden, code, geometry.rows,
                   geometry.smem_bytes)
    return h_new, c_new
