"""Per-channel-scaled int8 matmul: the precision axis of the serving path.

``x_q (M, K) int8 @ w_q (K, N) int8`` summed exactly in int32, then
``(acc.f32 * x_scale) * w_scale`` in f32: activations are quantized per
row, weights per output column (``kernels.ref.quantize_rowwise`` /
``quantize_colwise``), and both scales are applied in the epilogue.  The
kernel (``csrc/int8_matmul.cu``) and :func:`int8_matmul_plain` give the
same bits: the integer sum is exact and the epilogue runs in one order.

The kernel's geometry is chosen here, by :func:`plan`: the output tile, and
how K is cut into chunks that separate blocks sum (split-K) so that a small
M still spreads over the card's SMs.  The partial sums of a split meet in
an int32 workspace that this module allocates once per device and stream
(:func:`_workspace`) and that the kernel leaves zeroed.

Every quantized projection of ``models/quant.qeinsum`` goes through
:func:`int8_matmul`.  The JAX package launches its kernel only when M, K and
N are multiples of 128 (a TPU tiling rule); the port launches it for every
shape, since the kernel masks ragged edges.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import runtime

SMALL_M = 16        # up to this many rows (decode) a tile is 16 rows high
BLOCK_K = 64        # bytes of k per pipeline stage; `kBK` in csrc/int8_matmul.cu
# Largest K whose int32 sums cannot overflow: |x w| <= 128^2 for any int8
# pair (the quantizers give -127..127, but the kernel takes any int8).
MAX_K = (2**31 - 1) // (128 * 128)


class Plan(NamedTuple):
    block_m: int    # output rows of a block: 16, 64 or 128
    block_n: int    # output columns of a block: 64 or 128
    split_k: int    # chunks of K, one block each per output tile
    k_chunk: int    # bytes of K per chunk, a multiple of BLOCK_K

    def blocks(self, m: int, n: int) -> int:
        return self.tiles(m, n) * self.split_k

    def tiles(self, m: int, n: int) -> int:
        return -(-m // self.block_m) * -(-n // self.block_n)


def plan(m: int, k: int, n: int) -> Plan:
    """The kernel's geometry for an (m, k) x (k, n) product.

    Decode (m <= 16) is bound by the weight's bytes, so it wants many blocks
    in flight: 16-row tiles and K split until the grid holds at least
    2 x 132 blocks (two per SM).  Tiles are 128 columns wide (a block reads
    128 contiguous bytes of each weight row) where N is 4096 or more, else
    64, which keeps narrow weights (wk/wv, N = 1024) from splitting K into
    single stages.  Larger m is bound by the tensor cores:
    64 x 128 or 128 x 128 tiles, K split only while the tiles alone leave
    SMs idle (fewer than 132 blocks), and never below 8 stages (512 bytes)
    a chunk, so that the atomics of a split stay small beside its loads."""
    if m <= SMALL_M:
        block_m, target, min_steps = 16, 2 * runtime.SM_COUNT, 1
        block_n = 128 if n >= 4096 else 64
    elif m <= 64:
        block_m, block_n, target, min_steps = 64, 128, runtime.SM_COUNT, 8
    else:
        block_m, block_n, target, min_steps = 128, 128, runtime.SM_COUNT, 8
    steps = -(-k // BLOCK_K)
    tiles = -(-m // block_m) * -(-n // block_n)
    need = -(-target // tiles)
    per = max(steps // need, min(min_steps, steps), 1)
    return Plan(block_m, block_n, -(-steps // per), per * BLOCK_K)


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


_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
# workspaces that were outgrown: a captured CUDA graph may still point at them
_outgrown: list[tuple[torch.Tensor, torch.Tensor]] = []


def _workspace(dev: torch.device, ints: int, tiles: int):
    """Zeroed int32 partial sums (``ints``) and arrival counters (``tiles``)
    for split-K launches on the current stream of ``dev``, kept per device
    and stream (two streams sharing one would mix their partial sums) and
    grown when a call needs more.  The kernel returns them to zero, so they
    are allocated (``torch.zeros``) only when they grow, and never while a
    CUDA graph is being captured: a capture runs its step once uncaptured
    first, on the capture stream, which makes the workspace it needs."""
    key = (dev.index, runtime.stream_handle(dev))
    ws, cnt = _workspaces.get(key, (None, None))
    if ws is None or ws.numel() < ints or cnt.numel() < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("int8_matmul: the split-K workspace of the capture stream must "
                               "exist before the capture (run the step once on that stream)")
        if ws is not None:
            _outgrown.append((ws, cnt))
        ints = max(ints, 0 if ws is None else ws.numel())
        tiles = max(tiles, 0 if cnt is None else cnt.numel())
        ws = torch.zeros(ints, dtype=torch.int32, device=dev)
        cnt = torch.zeros(tiles, dtype=torch.int32, device=dev)
        _workspaces[key] = (ws, cnt)
    return ws, cnt


def int8_matmul(x_q, w_q, x_scale, w_scale):
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: (M, 1) f32; w_scale: (N,)
    f32 → (M, N) f32.  CUDA tensors launch the kernel, CPU tensors take the
    plain version.  K is at most ``MAX_K`` on either."""
    m, k, n = _check(x_q, w_q, x_scale, w_scale)
    if k > MAX_K:
        raise ValueError(f"int8_matmul: K = {k} could overflow the int32 sums (at most {MAX_K})")
    dev = runtime.require_same_device(x_q, w_q, x_scale, w_scale)
    if dev.type == "cpu":
        return int8_matmul_plain(x_q, w_q, x_scale, w_scale)
    for name, t in (("x_q", x_q), ("w_q", w_q), ("x_scale", x_scale), ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul takes contiguous tensors; {name} is not")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    xp, wp = x_q.data_ptr(), w_q.data_ptr()
    vec = int(k % 16 == 0 and n % 16 == 0 and xp % 16 == 0 and wp % 16 == 0)
    p = plan(m, k, n)
    ws = cnt = 0
    if p.split_k > 1:
        tiles = p.tiles(m, n)
        ws, cnt = (t.data_ptr() for t in _workspace(dev, tiles * p.block_m * p.block_n, tiles))
    runtime.launch("int8_matmul", "repro_int8_matmul", dev.index, xp, wp, x_scale.data_ptr(),
                   w_scale.data_ptr(), out.data_ptr(), ws, cnt, m, n, k, vec, p.block_m,
                   p.block_n, p.split_k, p.k_chunk)
    return out
