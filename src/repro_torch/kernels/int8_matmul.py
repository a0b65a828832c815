"""Per-channel-scaled int8 matmul: the precision axis of the serving path.

``x_q (M, K) int8 @ w_q (K, N) int8`` summed exactly in int32, then
``(acc.f32 * x_scale) * w_scale`` in f32: activations are quantized per
row, weights per output column (``kernels.ref.quantize_rowwise`` /
``quantize_colwise``), and both scales are applied in the epilogue.  The
kernel (``csrc/int8_matmul.cu``) and :func:`int8_matmul_plain` give the
same bits: the integer sum is exact and the epilogue runs in one order.

The kernel's geometry is chosen here, by :func:`plan` through the
block-size tuner (``kernels.autotune``): the output tile, and how K is cut
into chunks that separate blocks sum (split-K) so that a small M still
spreads over the card's SMs.  The partial sums of a split meet in
an int32 workspace kept once per device and stream
(``runtime.zeroed_workspace``) that the kernel leaves zeroed.

The operands may carry a batch axis, ``(E, M, K) @ (E, K, N)``: E products of
one shape in ONE launch, the batch index a grid axis of the kernel, as the
reference's ``jax.vmap`` of its ``pallas_call`` makes one launch with a batch
grid axis (the MoE expert einsums).  x and its scales may be shared by every
product (a batch stride of 0, ``Tensor.expand``): the MoE dense path hands
every expert the same token block, quantized once.  The plan and the tuner
see E, since a split of K that fills the card for one product over-splits
E of them.

Every quantized projection of ``models/quant.qeinsum`` goes through
:func:`int8_matmul`.  The JAX package launches its kernel only when M, K and
N are multiples of 128 (a TPU tiling rule); the port launches it for every
shape, since the kernel masks ragged edges.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime

SMALL_M = 16        # up to this many rows (decode) a tile is 16 rows high
BLOCK_K = 64        # bytes of k per pipeline stage; `kBK` in csrc/int8_matmul.cu
STAGES = 4          # stages of the cp.async ring; `kStages`
# the (block_m, block_n) output tiles the kernel is instantiated for
# (repro_int8_matmul in csrc/int8_matmul.cu)
TILES = ((16, 64), (16, 128), (64, 128), (128, 128))
# Largest K whose int32 sums cannot overflow: |x w| <= 128^2 for any int8
# pair (the quantizers give -127..127, but the kernel takes any int8).
MAX_K = (2**31 - 1) // (128 * 128)


class Plan(NamedTuple):
    block_m: int    # output rows of a block: 16, 64 or 128
    block_n: int    # output columns of a block: 64 or 128
    split_k: int    # chunks of K, one block each per output tile
    k_chunk: int    # bytes of K per chunk, a multiple of BLOCK_K

    def blocks(self, m: int, n: int, batch: int = 1) -> int:
        return self.tiles(m, n, batch) * self.split_k

    def tiles(self, m: int, n: int, batch: int = 1) -> int:
        """Output tiles of all ``batch`` products."""
        return batch * -(-m // self.block_m) * -(-n // self.block_n)


def smem_bytes(block_m: int, block_n: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the .cu file):
    ``STAGES`` x and w tiles of ``BLOCK_K`` bytes of k, and the transposed w
    tile."""
    return STAGES * (block_m * BLOCK_K + BLOCK_K * block_n) + block_n * BLOCK_K


def threads(block_m: int, block_n: int) -> int:
    """Threads of one block: a warp per (WARPS_M x WARPS_N) warp tile."""
    return 32 * (1 if block_m == SMALL_M else 2) * 4


@functools.lru_cache(maxsize=4096)
def plan_for(m: int, k: int, n: int, block_m: int, block_n: int, block_k: int,
             batch: int = 1) -> Plan:
    """The geometry for ``batch`` (m, k) x (k, n) products at an output tile
    the kernel is built for (``TILES``) and chunks of ``block_k`` bytes of K
    (a positive multiple of ``BLOCK_K``; a chunk longer than K is one chunk).
    Anything else raises a ``ValueError`` that names what is built."""
    if (block_m, block_n) not in TILES:
        raise ValueError(f"int8_matmul: no kernel is built for a {block_m} x {block_n} tile; "
                         f"the built (block_m, block_n) are {TILES}")
    if (isinstance(block_k, bool) or not isinstance(block_k, int) or block_k < BLOCK_K
            or block_k % BLOCK_K):
        raise ValueError(f"int8_matmul: block_k must be a positive multiple of {BLOCK_K} "
                         f"(bytes of K a chunk), got {block_k!r}")
    if min(m, k, n, batch) < 1:
        raise ValueError(f"int8_matmul: empty operand {batch} x ({m}, {k}) x ({k}, {n})")
    k_chunk = min(block_k, -(-k // BLOCK_K) * BLOCK_K)
    split_k = -(-k // k_chunk)
    if batch * split_k > 65535:
        raise ValueError(f"int8_matmul: {batch} products x {split_k} chunks of K, over the "
                         "kernel's 65535")
    return Plan(block_m, block_n, split_k, k_chunk)


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, block_m="auto", block_n="auto", block_k="auto",
         backend: str = "cpu", batch: int = 1) -> Plan:
    """:func:`plan_for` with every ``"auto"`` resolved by the block-size
    tuner (``kernels.autotune``, kernel ``int8_matmul``; its problem holds
    ``batch`` when there are several products): the built tile and
    the K chunks whose grid keeps enough weight bytes in flight to draw the
    memory rate at decode, and the tile with the least re-read weight at
    larger M.  Fields given explicitly are kept, the others taken from the
    best-ranked candidate that agrees with them.  Memoized per shape and
    arguments, so that the captured decode and verify ticks, which resolve
    it on every launch, reach the tuner only in their warm-up."""
    given = {f: v for f, v in (("block_m", block_m), ("block_n", block_n),
                               ("block_k", block_k)) if v != "auto"}
    if len(given) < 3:
        from repro_torch.kernels import autotune

        # one product's problem has no "batch", so that its key is the one it always had
        problem = {"m": m, "k": k, "n": n, **({"batch": batch} if batch > 1 else {})}
        if not given:
            given = autotune.autotune("int8_matmul", problem, dtype="int8", backend=backend)
        else:
            pairs = [t for t in TILES if given.get("block_m", t[0]) == t[0]
                     and given.get("block_n", t[1]) == t[1]]
            if not pairs:
                raise ValueError(f"int8_matmul: no kernel is built for {given}; the built "
                                 f"(block_m, block_n) are {TILES}")
            if "block_k" in given:  # refused here with the kernel's own bound
                plan_for(m, k, n, *pairs[0], given["block_k"], batch)
            chunks = [given["block_k"]] if "block_k" in given else autotune.k_chunks(k)
            given = min(({"block_m": bm, "block_n": bn, "block_k": bk}
                         for bm, bn in pairs for bk in chunks),
                        key=lambda c: (autotune.predict_time_s("int8_matmul", problem, c,
                                                               dtype="int8"),
                                       tuple(sorted(c.items()))))
    return plan_for(m, k, n, given["block_m"], given["block_n"], given["block_k"], batch)


# bytes of float64 weight the plain version converts at once: a batch of
# large products (256 experts of 7168 x 2048) runs in slices of the batch
PLAIN_BYTES = 1 << 30


def int8_matmul_plain(x_q, w_q, x_scale, w_scale):
    """Plain PyTorch version of the kernel, for one product or a batch.  The
    product runs in float64, where it is exact (|acc| <= 127^2 K < 2^53) and
    which CUDA supports, unlike an integer matmul; it is then converted to
    f32 once.  A batch runs in slices of at most ``PLAIN_BYTES`` of float64
    weight."""
    if w_q.dim() == 3:
        step = max(1, PLAIN_BYTES // (8 * w_q[0].numel()))
        if w_q.shape[0] > step:
            return torch.cat([int8_matmul_plain(x_q[i:i + step], w_q[i:i + step],
                                                x_scale[i:i + step], w_scale[i:i + step])
                              for i in range(0, w_q.shape[0], step)])
    return _plain(x_q, w_q, x_scale, w_scale)


def _plain(x_q, w_q, x_scale, w_scale):
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    return acc.to(torch.float32) * x_scale * w_scale[..., None, :]


def _check(x_q, w_q, x_scale, w_scale) -> tuple[int, int, int, int]:
    """(batch, M, K, N) of consistent operands, batch 1 for 2-D ones."""
    for name, t, dtype in (("x_q", x_q, torch.int8), ("w_q", w_q, torch.int8),
                           ("x_scale", x_scale, torch.float32),
                           ("w_scale", w_scale, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"int8_matmul: {name} must be {dtype}, got {t.dtype}")
    nd = x_q.dim()
    if nd != w_q.dim() or nd not in (2, 3):
        raise ValueError(f"int8_matmul: x_q and w_q must both be 2-D, or both 3-D (a batch), "
                         f"got {tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if nd == 2:
        batch, (m, k), n = 1, x_q.shape, w_q.shape[1]
        ok = w_q.shape[0] == k and x_scale.shape == (m, 1) and w_scale.shape == (n,)
    else:
        (batch, m, k), n = x_q.shape, w_q.shape[2]
        ok = (w_q.shape == (batch, k, n) and x_scale.shape == (batch, m, 1)
              and w_scale.shape == (batch, n))
    if not ok:
        raise ValueError(
            f"int8_matmul: inconsistent shapes x_q {tuple(x_q.shape)} w_q {tuple(w_q.shape)} "
            f"x_scale {tuple(x_scale.shape)} w_scale {tuple(w_scale.shape)}")
    if min(batch, m, k, n) < 1:
        raise ValueError(f"int8_matmul: empty operand {batch} x ({m}, {k}) x ({k}, {n})")
    return batch, m, k, n


def _x_shared(x_q: torch.Tensor, x_scale: torch.Tensor) -> int:
    """1 if a 3-D x and its scales are one product's, shared by every
    product (``Tensor.expand``: batch stride 0), 0 if they are stacked, one
    contiguous product per batch index.  Both are one or the other."""
    shared = int(x_q.shape[0] > 1 and x_q.stride(0) == 0)
    for name, t in (("x_q", x_q), ("x_scale", x_scale)):
        if t.shape[0] > 1 and t.stride(0) != (0 if shared else t[0].numel()):
            raise ValueError(f"int8_matmul takes x_q and x_scale both shared (batch stride 0) "
                             f"or both stacked; {name} has strides {t.stride()}")
    return shared


def int8_matmul(x_q, w_q, x_scale, w_scale, *, block_m="auto", block_n="auto",
                block_k="auto"):
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: (M, 1) f32; w_scale: (N,)
    f32 → (M, N) f32.  Or a batch of E products in one launch: x_q (E, M, K),
    w_q (E, K, N), x_scale (E, M, 1), w_scale (E, N) → (E, M, N), where x_q
    and x_scale may be one product's expanded over the batch.  CUDA tensors
    launch the kernel, CPU tensors take the plain version.  K is at most
    ``MAX_K`` on either.  The geometry is :func:`plan`'s (a tile or chunk the
    kernel is not built for raises ``ValueError`` on either device); the
    result does not depend on it."""
    batch, m, k, n = _check(x_q, w_q, x_scale, w_scale)
    if k > MAX_K:
        raise ValueError(f"int8_matmul: K = {k} could overflow the int32 sums (at most {MAX_K})")
    dev = runtime.require_same_device(x_q, w_q, x_scale, w_scale)
    if dev.type == "cpu":
        if (block_m, block_n, block_k) != ("auto", "auto", "auto"):
            plan(m, k, n, block_m, block_n, block_k, batch=batch)  # refuses what the card would
        return int8_matmul_plain(x_q, w_q, x_scale, w_scale)
    shared = _x_shared(x_q, x_scale) if x_q.dim() == 3 else 0
    for name, t in (("x_q", x_q[0] if x_q.dim() == 3 else x_q), ("w_q", w_q),
                    ("x_scale", x_scale[0] if x_q.dim() == 3 else x_scale),
                    ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul takes contiguous tensors; {name} is not")
    out = torch.empty((*x_q.shape[:-2], m, n), dtype=torch.float32, device=dev)
    xp, wp = x_q.data_ptr(), w_q.data_ptr()
    vec = int(k % 16 == 0 and n % 16 == 0 and xp % 16 == 0 and wp % 16 == 0)
    p = plan(m, k, n, block_m, block_n, block_k, runtime.CUDA_BACKEND, batch)
    ws = cnt = 0
    if p.split_k > 1:
        tiles = p.tiles(m, n, batch)
        ws = runtime.zeroed_workspace("int8_matmul.sums", dev,
                                      tiles * p.block_m * p.block_n).data_ptr()
        cnt = runtime.zeroed_workspace("int8_matmul.counters", dev, tiles).data_ptr()
    runtime.launch("int8_matmul", "repro_int8_matmul", dev.index, xp, wp, x_scale.data_ptr(),
                   w_scale.data_ptr(), out.data_ptr(), ws, cnt, m, n, k, vec, p.block_m,
                   p.block_n, p.split_k, p.k_chunk, batch, shared)
    return out
