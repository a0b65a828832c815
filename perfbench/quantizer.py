"""Symmetric int8 quantizers, frozen here so that the yardstick cannot move.

Copied from ``src/repro_torch/kernels/ref.py`` (``_div127``,
``quantize_rowwise``, ``quantize_colwise``) at commit d0d3ca4: the scale is
max(amax, 1e-8) / 127 in f32, the payload round-half-to-even of a TRUE
division by a tensor divisor, clipped to +-127.  ``quantize_weight``
applies the column rule to every matrix of a stacked weight at once (the
same bytes as a loop over the stack, as ``models/quant.quantize_weight``
takes them); ``levels`` gives the control's coarser grid (7 for int4).
"""
from __future__ import annotations

import torch


def _div(amax: torch.Tensor, levels: int) -> torch.Tensor:
    return amax.clamp_min(1e-8) / torch.full((), float(levels), dtype=torch.float32,
                                             device=amax.device)


def quantize_rowwise(x: torch.Tensor, levels: int = 127):
    """Per-row quantization of (M, K): (x_q, scale (M, 1))."""
    scale = _div(x.to(torch.float32).abs().amax(dim=-1, keepdim=True), levels)
    return torch.round(x / scale).clamp(-levels, levels).to(torch.int8), scale


def quantize_weight(w: torch.Tensor, lead: int, contract: int, levels: int = 127):
    """``w``: (lead axes, contract axes, out axes).  Per output column over
    the contraction axes, for every lead index at once.  Returns (q int8 in
    w's layout, f32 scale of shape lead + out)."""
    axes = tuple(range(lead, lead + contract))
    amax = w.to(torch.float32).abs().amax(dim=axes, keepdim=True)
    scale = _div(amax, levels)
    q = torch.round(w / scale).clamp(-levels, levels).to(torch.int8)
    return q, scale.reshape(*w.shape[:lead], *w.shape[lead + contract:])


def dequantize(q: torch.Tensor, scale: torch.Tensor, lead: int, contract: int) -> torch.Tensor:
    """f32 weight from ``quantize_weight``'s pair."""
    shape = (*q.shape[:lead], *([1] * contract), *q.shape[lead + contract:])
    return q.to(torch.float32) * scale.reshape(shape)


def fake_quant_rows(x: torch.Tensor, levels: int = 127) -> torch.Tensor:
    """x quantized per row (last axis) and dequantized, in f32."""
    flat = x.reshape(-1, x.shape[-1]).to(torch.float32)
    q, s = quantize_rowwise(flat, levels)
    return (q.to(torch.float32) * s).reshape(x.shape)
