"""Blocked online-softmax ("flash") attention with GQA.

Layouts as in the JAX package: q (B, H, Sq, D); k/v (B, KV, Sk, D); query
head h reads KV head h // (H / KV).  f32 or bf16 inputs, upcast to f32 for
both products; the output has q's type.  The causal mask is top-left
aligned (query i sees keys 0..i), masked scores are ``-1e30`` (not -inf),
and the result is ``acc / max(l, 1e-37)``, so a row whose scores are all
masked averages its values uniformly, as the reference's does.

The kernel (``csrc/flash_attention.cu``) walks the keys in tiles of
``TILE_K`` rows; :func:`flash_attention_plain` repeats its arithmetic tile by
tile in PyTorch.  Unlike the TPU kernel, neither asks the tiles to divide
Sq or Sk: ragged edges are masked.

The serving path does not call this kernel (``models/layers.py`` runs its
attention in plain tensor ops, as the JAX package does); it is reached
through ``kernels/ops.flash_attention``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import runtime

NEG_INF = -1e30
TILE_K = 32               # key rows per tile; `kTileK` in csrc/flash_attention.cu
HEAD_DIMS = (16, 32, 64, 128)  # head widths the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain PyTorch version of the kernel: the same tiles, the same
    online-softmax updates, over all query rows at once."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.to(torch.float32)
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, TILE_K):
        kt = k[:, :, k0:k0 + TILE_K].to(torch.float32).repeat_interleave(g, dim=1)
        vt = v[:, :, k0:k0 + TILE_K].to(torch.float32).repeat_interleave(g, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vt)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-37)).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B, H, Sq, D) and k, v (B, KV, Sk, D)")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: inconsistent shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"flash_attention: {k.shape[1]} KV heads do not divide {h} heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16, all of one type; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) → (B, H, Sq, D) of q's type.
    CUDA tensors launch the kernel (head widths in ``HEAD_DIMS``), CPU
    tensors take the plain version."""
    _check(q, k, v)
    dev = runtime.require_same_device(q, k, v)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel is built for head widths {HEAD_DIMS}, "
                         f"not {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention takes contiguous tensors; {name} is not")
    lib = runtime.load_kernels()
    out = torch.empty_like(q)
    with runtime.device_guard(dev):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, k.shape[1], sq,
            k.shape[2], d, int(causal), _DTYPES[q.dtype], 1.0 / math.sqrt(d),
            runtime.current_stream())
    runtime.check_launch(rc, "flash_attention")
    runtime.count_launch("flash_attention")
    return out
