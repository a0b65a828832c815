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

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.activations import apply_variant_plain, impl_code
from repro_torch.models.activations import LUT_SIZE, _sigmoid_table


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


def _check_f32(kernel: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel} takes float32 tensors, got {name} of {t.dtype}")


def _contiguous(kernel: str, **tensors: torch.Tensor) -> None:
    """What the kernels' 16-byte loads need of the tensors they are handed."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{kernel} takes contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel} takes 16-byte aligned tensors; {name} is not")


def lstm_cell_fused(x, h, c, w, u, b, *, impl: str = "exact", block_b: int | str = "auto"):
    """x: (B, D); h/c: (B, H); w: (D, 4H); u: (H, 4H); b: (4H,); all f32
    (anything else raises).  Returns (h', c').

    ``block_b`` is the batch tile of one thread block; ``"auto"`` follows
    the fixed rule of :func:`runtime.pick_block_b`.
    """
    code = impl_code(impl)
    _check_f32("lstm_cell", x=x, h=h, c=c, w=w, u=u, b=b)
    bsz, d_in = x.shape
    hidden = h.shape[1]
    if (h.shape != (bsz, hidden) or c.shape != (bsz, hidden) or w.shape != (d_in, 4 * hidden)
            or u.shape != (hidden, 4 * hidden) or b.shape != (4 * hidden,)):
        raise ValueError(
            f"lstm_cell: inconsistent shapes x {tuple(x.shape)} h {tuple(h.shape)} "
            f"c {tuple(c.shape)} w {tuple(w.shape)} u {tuple(u.shape)} b {tuple(b.shape)}"
        )
    dev = runtime.require_same_device(x, h, c, w, u, b)
    bb = runtime.pick_block_b(block_b, bsz, lambda n: cell_smem_bytes(n, d_in, hidden),
                              "lstm_cell")
    if dev.type == "cpu":
        return lstm_cell_plain(x, h, c, w, u, b, impl=impl)
    _contiguous("lstm_cell", x=x, h=h, c=c, w=w, u=u, b=b)
    lib = runtime.load_kernels()
    h_new = torch.empty_like(h)
    c_new = torch.empty_like(c)
    table = _sigmoid_table(dev)
    with runtime.device_guard(dev):
        rc = lib.repro_lstm_cell(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(), u.data_ptr(), b.data_ptr(),
            table.data_ptr(), h_new.data_ptr(), c_new.data_ptr(), bsz, d_in, hidden, code, bb,
            cell_smem_bytes(bb, d_in, hidden), runtime.current_stream(),
        )
    runtime.check_launch(rc, "lstm_cell")
    runtime.count_launch("lstm_cell")
    return h_new, c_new
