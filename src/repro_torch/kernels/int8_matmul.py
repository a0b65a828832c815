"""Per-channel-scaled int8 matmul: the precision axis of the serving path.

``x_q (M, K) int8 @ w_q (K, N) int8`` summed exactly in int32, then
``(acc.f32 * x_scale) * w_scale`` in f32: activations are quantized per
row, weights per output column (``kernels.ref.quantize_rowwise`` /
``quantize_colwise``), and both scales are applied in the epilogue.  The
kernel (``csrc/int8_matmul.cu``) and :func:`int8_matmul_plain` give the
same bits: the integer sum is exact and the epilogue runs in one order.

Every quantized projection of ``models/quant.qeinsum`` goes through
:func:`int8_matmul`.  The JAX package launches its kernel only when M, K and
N are multiples of 128 (a TPU tiling rule); the port launches it for every
shape, since the kernel masks ragged edges.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime

SMALL_M = 16  # up to this many rows a tile is 16 x 64, else 64 x 64


def int8_matmul_plain(x_q, w_q, x_scale, w_scale):
    """Plain PyTorch version of the kernel.  The product runs in float64,
    where it is exact (|acc| <= 127^2 K < 2^53) and which CUDA supports,
    unlike an integer matmul; it is then converted to f32 once."""
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    return acc.to(torch.float32) * x_scale * w_scale[None, :]


def _check(x_q, w_q, x_scale, w_scale) -> tuple[int, int, int]:
    for name, t, dtype in (("x_q", x_q, torch.int8), ("w_q", w_q, torch.int8),
                           ("x_scale", x_scale, torch.float32),
                           ("w_scale", w_scale, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"int8_matmul: {name} must be {dtype}, got {t.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"int8_matmul: x_q and w_q must be 2-D, got {tuple(x_q.shape)} "
                         f"and {tuple(w_q.shape)}")
    m, k = x_q.shape
    n = w_q.shape[1]
    if w_q.shape[0] != k or tuple(x_scale.shape) != (m, 1) or tuple(w_scale.shape) != (n,):
        raise ValueError(
            f"int8_matmul: inconsistent shapes x_q {tuple(x_q.shape)} w_q {tuple(w_q.shape)} "
            f"x_scale {tuple(x_scale.shape)} w_scale {tuple(w_scale.shape)}")
    if min(m, k, n) < 1:
        raise ValueError(f"int8_matmul: empty operand ({m}, {k}) x ({k}, {n})")
    return m, k, n


def int8_matmul(x_q, w_q, x_scale, w_scale):
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: (M, 1) f32; w_scale: (N,)
    f32 → (M, N) f32.  CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    m, k, n = _check(x_q, w_q, x_scale, w_scale)
    dev = runtime.require_same_device(x_q, w_q, x_scale, w_scale)
    if dev.type == "cpu":
        return int8_matmul_plain(x_q, w_q, x_scale, w_scale)
    for name, t in (("x_q", x_q), ("w_q", w_q), ("x_scale", x_scale), ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul takes contiguous tensors; {name} is not")
    lib = runtime.load_kernels()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    vec_x = int(k % 4 == 0 and x_q.data_ptr() % 4 == 0)
    vec_w = int(n % 4 == 0 and w_q.data_ptr() % 4 == 0)
    block_m = SMALL_M if m <= SMALL_M else 64
    with runtime.device_guard(dev):
        rc = lib.repro_int8_matmul(
            x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
            out.data_ptr(), m, n, k, vec_x, vec_w, block_m, runtime.current_stream())
    runtime.check_launch(rc, "int8_matmul")
    runtime.count_launch("int8_matmul")
    return out
