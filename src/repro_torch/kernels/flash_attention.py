"""Blocked online-softmax ("flash") attention with GQA.

Layouts as in the JAX package: q (B, H, Sq, D); k/v (B, KV, Sk, D); query
head h reads KV head h // (H / KV).  f32 or bf16 inputs, both products
summed in f32; the output has q's type.  The causal mask is top-left
aligned (query i sees keys 0..i), masked scores are ``-1e30`` (not -inf),
and the result is ``acc / max(l, 1e-37)``, so a row whose scores are all
masked averages its values uniformly, as the reference's does.

Two kernels in ``csrc/flash_attention.cu``, both on the tensor cores.  f32
inputs run in key tiles of ``TILE_K`` rows on ``mma.sync`` m16n8k8 TF32 in
split precision: each operand is split into a TF32 high part and a TF32
low part, and each product is summed as lo·hi + hi·lo + hi·hi in f32, which
holds the reference's f32 tolerance where TF32 alone would not; p stays
f32, as in the reference.  bf16 inputs run in key tiles of ``TILE_K_BF16``
rows on ``mma.sync`` m16n8k16, and round the probabilities p to bf16 before
``p @ v`` (the reference keeps them in f32; the row sum l is taken before
the rounding).  :func:`flash_attention_plain` repeats each kernel's tiles
and online-softmax updates in plain f32 PyTorch, the bf16 rounding of p
included.  Unlike the TPU kernel, neither asks the tiles to divide Sq or
Sk: ragged edges are masked.

The serving path does not call this kernel (``models/layers.py`` runs its
attention in plain tensor ops, as the JAX package does); it is reached
through ``kernels/ops.flash_attention``.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import runtime

NEG_INF = -1e30
ROWS_Q = 64               # query rows per block of both kernels; `kF32RowsQ`, `kMmaRowsQ`
TILE_K = 32               # key rows per tile of the f32 kernel; `kF32TileK` in the .cu file
STAGES_F32 = 2            # key/value tiles in flight; `kF32Stages`
ROW_PAD_QK_F32 = 8        # floats of padding per shared q and k row; `kPadQK`
ROW_PAD_V_F32 = 4         # floats of padding per shared v row; `kPadV`
TILE_K_BF16 = 64          # key rows per tile of the bf16 kernel; `kMmaTileK`
STAGES_BF16 = 2           # key/value tiles in flight; `kMmaStages`
ROW_PAD_BF16 = 8          # bf16 elements of padding per shared row; `kRowPad`
HEAD_DIMS = (16, 32, 64, 128)  # head widths the kernels are built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (query rows, key rows) of a block's tiles, by input type: what each kernel
# is built with
BUILT_TILES = {"float32": (ROWS_Q, TILE_K), "bfloat16": (ROWS_Q, TILE_K_BF16)}


@functools.lru_cache(maxsize=1024)
def tiles(q_dtype: torch.dtype, block_q, block_k, shape: tuple[int, ...],
          backend: str = "cpu") -> tuple[int, int]:
    """The (block_q, block_k) of a launch: the tuner's pick for ``"auto"``
    (``kernels.autotune``, kernel ``flash_attention``: one built tile per
    type), and explicit values only where the kernel is built with them;
    any other raises a ``ValueError`` that names the built tiles.  ``shape``
    is (B, H, Sq, Sk, D); memoized, so the tuner is asked once a shape."""
    kind = str(q_dtype).replace("torch.", "")
    if kind not in BUILT_TILES:
        raise TypeError(f"flash_attention takes f32 or bf16, got {q_dtype}")
    built = BUILT_TILES[kind]
    if "auto" in (block_q, block_k):
        from repro_torch.kernels import autotune

        b, h, sq, sk, d = shape
        best = autotune.autotune("flash_attention", {"b": b, "h": h, "sq": sq, "sk": sk, "d": d},
                                 dtype=kind, backend=backend)
        block_q = best["block_q"] if block_q == "auto" else block_q
        block_k = best["block_k"] if block_k == "auto" else block_k
    if (block_q, block_k) != built:
        raise ValueError(f"flash_attention: no {kind} kernel is built with tiles "
                         f"({block_q}, {block_k}); the built (block_q, block_k) are {BUILT_TILES}")
    return built


def flash_smem_bytes(d: int, kind: str) -> int:
    """Dynamic shared memory of one block of the ``kind`` ("float32" or
    "bfloat16") kernel.  bf16: ``STAGES_BF16`` key and value tiles, rows of
    ``d + ROW_PAD_BF16`` bf16 (the padding puts the 8 rows one ldmatrix reads
    in 8 bank groups); the q tile passes through stage 1's key tile before
    the loop starts.  f32: the q tile, which stays (its fragments are split
    again at every key tile), and ``STAGES_F32`` key and value tiles; q and
    k rows hold ``d + ROW_PAD_QK_F32`` floats and v rows ``d +
    ROW_PAD_V_F32`` (pitches of 8 and 4 mod 16 floats, so that a warp's
    fragment loads fall in distinct banks).  The C entry point recomputes it
    and refuses a launch (-1) on disagreement."""
    if kind == "bfloat16":
        return 2 * STAGES_BF16 * TILE_K_BF16 * (d + ROW_PAD_BF16) * 2
    if kind == "float32":
        qk, vv = d + ROW_PAD_QK_F32, d + ROW_PAD_V_F32
        return 4 * (ROWS_Q * qk + STAGES_F32 * TILE_K * (qk + vv))
    raise TypeError(f"flash_attention takes float32 or bfloat16, not {kind}")


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain PyTorch version of the kernels: the same tiles, the same
    online-softmax updates, over all query rows at once, in plain f32
    products (the f32 kernel's split TF32 products agree with them to about
    2^-20 of each product); for bf16 inputs p is rounded to bf16 before
    ``p @ v``, as the bf16 kernel does."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.to(torch.float32)
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    tile = TILE_K_BF16 if bf16 else TILE_K
    for k0 in range(0, sk, tile):
        kt = k[:, :, k0:k0 + tile].to(torch.float32).repeat_interleave(g, dim=1)
        vt = v[:, :, k0:k0 + tile].to(torch.float32).repeat_interleave(g, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if bf16:
            p = p.to(torch.bfloat16).to(torch.float32)
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


def flash_attention(q, k, v, *, causal: bool = True, block_q="auto", block_k="auto"):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) → (B, H, Sq, D) of q's type.
    CUDA tensors launch a kernel (head widths in ``HEAD_DIMS``, base
    pointers 16-byte aligned), CPU tensors take the plain version.  Tiles
    other than the kernel's (:func:`tiles`) raise on either device."""
    _check(q, k, v)
    dev = runtime.require_same_device(q, k, v)
    tiles(q.dtype, block_q, block_k, (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]),
          runtime.CUDA_BACKEND if dev.type == "cuda" else "cpu")
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel is built for head widths {HEAD_DIMS}, "
                         f"not {d}")
    ptrs = runtime.aligned_pointers("flash_attention", ("q", "k", "v"), q, k, v)
    out = torch.empty_like(q)
    smem = flash_smem_bytes(d, str(q.dtype).replace("torch.", ""))
    runtime.launch("flash_attention", "repro_flash_attention", dev.index, *ptrs, out.data_ptr(),
                   b, h, k.shape[1], sq, k.shape[2], d, int(causal), _DTYPES[q.dtype], smem)
    return out
