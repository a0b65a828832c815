"""Decode attention over the live rows of a KV cache: one query a row,
grouped-query (GQA), flash-decoding.

``q`` (B, 1, H, D) against caches (B, Smax, KV, D), query head h reading KV
head h // (H / KV); row b attends over cache rows 0..pos[b] inclusive (the
cache is already written at pos).  Scores ``q·k / sqrt(D)`` and the softmax
in f32 from the cache's values, P·V in f32, cast once to q's type: the
arithmetic of :func:`decode_attention_plain`, the tensor ops the port's
decode attention ran before this kernel (``models/layers.py``), written
again here: K and V expanded to every query head in f32, every row of the
capacity scored and the rows past pos masked to weight 0.

The kernel (``csrc/decode_attention.cu``) reads each live K and V row once
in the cache's type for all g = H / KV query heads of its KV head, and no
row past pos[b]: ``pos`` is read on the device, so a captured CUDA graph
replays it for any positions.  The sums run in another order than the
plain version's, and rows past pos are never read, so what they hold does
not matter (the plain version's 0 · NaN is NaN: a NaN there poisons its
row, not the kernel's).  A position outside [0, Smax) is clamped into it.

The geometry (:func:`plan`) comes from the shapes alone: ``heads``, the
query heads a block takes (all g of a KV head, up to ``GROUP_MAX``), and
the capacity cut into ``splits`` of ``rows`` rows, one block each, so that
a full pool gives about ``BLOCKS_PER_SM`` blocks an SM.  The splits of a
row merge in the kernel (the last of them to finish, by an atomic ticket on
a counter of ``runtime.zeroed_workspace``, zero between launches).

CUDA tensors launch the kernel or raise; CPU tensors take the plain version.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 112, 128)   # head widths the kernel is built for (every GQA config's)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}   # of q and of the caches: the kernel's flags
POS_DTYPES = {torch.int32: 0, torch.int64: 1}
GROUP_MAX = 8         # query heads a block holds at most; the kernel's G
ROW_MAX = 512         # rows of a split at most; `kRowMax` in the .cu file
ROW_ALIGN = 64        # a split's rows are a multiple of this
BLOCKS_PER_SM = 16    # blocks a full pool gives an SM


class Plan(NamedTuple):
    heads: int    # query heads a block takes (divides g, at most GROUP_MAX)
    rows: int     # cache rows a split, at most ROW_MAX
    splits: int   # splits of the capacity: ceil(Smax / rows)


@functools.lru_cache(maxsize=1024)
def plan(b: int, smax: int, kv: int, g: int) -> Plan:
    """The geometry for B rows of a capacity of ``smax`` rows, ``kv`` KV
    heads and ``g`` query heads each: the largest divisor of g up to
    ``GROUP_MAX`` as the heads of a block, then splits of a multiple of
    ``ROW_ALIGN`` rows (at most ``ROW_MAX``) enough for ``BLOCKS_PER_SM``
    blocks an SM when every row is live."""
    if min(b, smax, kv, g) < 1:
        raise ValueError(f"decode_attention: empty shape B={b} Smax={smax} KV={kv} g={g}")
    heads = max(h for h in range(1, GROUP_MAX + 1) if g % h == 0)
    pairs = b * kv * (g // heads)
    want = -(-BLOCKS_PER_SM * runtime.SM_COUNT // pairs)
    rows = runtime.round_up(-(-smax // want), ROW_ALIGN)
    rows = min(max(rows, ROW_ALIGN), ROW_MAX)
    return Plan(heads, rows, -(-smax // rows))


def plain_scores(q, k_cache, v_cache, valid):
    """The plain version's first half: K and V expanded to every query head
    in f32, every cache row scored (B, H, 1, Sk), the rows where ``valid``
    (B, Sk) is false set to ``NEG_INF`` (``valid`` None: none).  Returns the
    scores and the expanded V.  Also the mesh's split path
    (``models/layers.attention_decode``), which takes its softmax over
    ranks."""
    b, _, h, d = q.shape
    smax, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh

    def expand(c):
        return c[:, :, :, None, :].expand(b, smax, kvh, g, d).reshape(b, smax, h, d)

    k = expand(k_cache) if g > 1 else k_cache
    v = expand(v_cache) if g > 1 else v_cache
    sqrt_d = float(torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) / sqrt_d
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    return s, v.to(torch.float32)


def decode_attention_plain(q, k_cache, v_cache, pos):
    """Plain PyTorch version: K and V expanded to every query head in f32,
    every cache row scored, the rows past pos masked to ``NEG_INF``."""
    valid = torch.arange(k_cache.shape[1], device=q.device)[None, :] <= pos[:, None]
    s, v = plain_scores(q, k_cache, v_cache, valid)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v).to(q.dtype)


def _check(q, k_cache, v_cache, pos) -> tuple[int, int, int, int, int]:
    """(B, H, D, Smax, KV) of consistent operands."""
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention takes q (B, 1, H, D) and caches (B, Smax, KV, D), "
                         f"got {tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, _, h, d = q.shape
    _, smax, kv, dk = k_cache.shape
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != b or dk != d:
        raise ValueError(f"decode_attention: inconsistent shapes q {tuple(q.shape)} k "
                         f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    if h % kv:
        raise ValueError(f"decode_attention: {kv} KV heads do not divide {h} heads")
    if pos is None or pos.shape != (b,):
        raise ValueError(f"decode_attention takes one position a row, pos of shape ({b},); "
                         f"got {None if pos is None else tuple(pos.shape)}")
    return b, h, d, smax, kv


def decode_attention(q, k_cache, v_cache, pos):
    """q: (B, 1, H, D); k_cache, v_cache: (B, Smax, KV, D); pos: (B,) →
    (B, 1, H, D) of q's type, row b over cache rows 0..pos[b].  CUDA
    tensors launch the kernel: D in ``HEAD_DIMS``, caches bf16 or f32 (one
    type), contiguous and 16-byte aligned, q bf16 or f32, pos int32 or
    int64; anything else raises.  CPU tensors take the plain version."""
    b, h, d, smax, kv = _check(q, k_cache, v_cache, pos)
    dev = runtime.require_same_device(q, k_cache, v_cache, pos)
    if dev.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos)
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: the kernel is built for head widths {HEAD_DIMS}, "
                         f"not {d}")
    if k_cache.dtype not in DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode_attention takes bf16 or f32 caches of one type, got "
                        f"{k_cache.dtype} and {v_cache.dtype}")
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention takes a bf16 or f32 q, got {q.dtype}")
    if pos.dtype not in POS_DTYPES:
        raise TypeError(f"decode_attention takes int32 or int64 positions, got {pos.dtype}")
    for name, t in (("q", q), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention takes contiguous tensors; {name} is not")
    kp, vp = runtime.aligned_pointers("decode_attention", ("k_cache", "v_cache"), k_cache, v_cache)
    p = plan(b, smax, kv, h // kv)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=dev)
    merge = (0, 0, 0)
    if p.splits > 1:  # held until the launch, so that no two of them share memory
        part_o = torch.empty((b, h, p.splits, d), dtype=torch.float32, device=dev)
        part_ml = torch.empty((b, h, p.splits, 2), dtype=torch.float32, device=dev)
        tickets = runtime.zeroed_workspace("decode_attention.tickets", dev, b * (h // p.heads))
        merge = (part_o.data_ptr(), part_ml.data_ptr(), tickets.data_ptr())
    runtime.launch("decode_attention", "repro_decode_attention", dev.index, q.data_ptr(), kp, vp,
                   pos.data_ptr(), out.data_ptr(), *merge, b, smax, kv, h, d, p.heads, p.rows,
                   p.splits, DTYPES[q.dtype], DTYPES[k_cache.dtype],
                   POS_DTYPES[pos.dtype])
    return out
