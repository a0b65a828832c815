"""Decode-cache definitions of the port's families.

  GQA families    k/v: (L, B, S, KV, hd)                      in ``cfg.kv_dtype or cfg.dtype``
  MLA (deepseek)  c: (L, B, S, r), krope: (L, B, S, rope_d)   compressed, same type
  SSM (mamba2)    conv: (L, B, W-1, d_inner+2N) same type, state: (L, B, H, P, N) f32
  hybrid (zamba2) the SSM leaves + shared-attention k/v: (applications, B, S, KV, hd)
  audio (whisper) k/v: (L, B, S, KV, hd) + cross_k/cross_v: (L, B, encoder_seq, KV, hd),
                  the cross leaves fixed at the encoder's frames, whatever S

ParamDef trees, as in the JAX package, so the cache is initialised by the
same machinery as the weights.  The paged pool (``serving/pages.py``) pages
the leaves ``paged_keys`` names, those with a sequence axis, in the layout
of ``page_defs``: ``(lead, num_pages, page_size, ...)``, optionally as int8
payloads with an f32 scale a row (``quantize_kv`` / ``dequantize_kv``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamDef, tree_leaves
from repro_torch.models.ssm import conv_channels


def _kv(num_layers: int, b: int, s: int, kv: int, hd: int, dtype) -> ParamDef:
    return ParamDef(
        (num_layers, b, s, kv, hd),
        ("layers", "batch", "kv_seq", "kv_heads", None),
        init="zeros",
        dtype=dtype,
    )


def cache_defs(cfg: ArchConfig, *, batch: int, max_len: int) -> dict:
    f = cfg.family
    if f not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio"):
        raise ValueError(f"unknown family {f!r}")
    l, hd, kv = cfg.num_layers, cfg.resolved_head_dim, cfg.num_kv_heads
    dt = cfg.kv_dtype or cfg.dtype
    if f in ("ssm", "hybrid"):  # recurrent leaves: O(1) in max_len
        sm = cfg.ssm
        out = {
            "conv": ParamDef((l, batch, sm.conv_width - 1, conv_channels(cfg)),
                             ("layers", "batch", None, None), init="zeros", dtype=dt),
            "state": ParamDef((l, batch, sm.num_heads(cfg.d_model), sm.head_dim, sm.state_size),
                              ("layers", "batch", "ssm_heads", None, None), init="zeros",
                              dtype=torch.float32),
        }
        if f == "hybrid":
            n_apps = math.ceil(cfg.num_layers / cfg.attn_every)
            out["shared_k"] = _kv(n_apps, batch, max_len, kv, hd, dt)
            out["shared_v"] = _kv(n_apps, batch, max_len, kv, hd, dt)
        return out
    if cfg.mla is not None:  # deepseek: the compressed cache
        m = cfg.mla
        axes = ("layers", "batch", "kv_seq", None)
        return {"c": ParamDef((l, batch, max_len, m.kv_lora_rank), axes, init="zeros", dtype=dt),
                "krope": ParamDef((l, batch, max_len, m.qk_rope_head_dim), axes, init="zeros",
                                  dtype=dt)}
    out = {"k": _kv(l, batch, max_len, kv, hd, dt), "v": _kv(l, batch, max_len, kv, hd, dt)}
    if f == "audio":  # the cross-attention's K/V over the encoder's frames
        out["cross_k"] = _kv(l, batch, cfg.encoder_seq, kv, hd, dt)
        out["cross_v"] = _kv(l, batch, cfg.encoder_seq, kv, hd, dt)
    return out


def _defs_bytes(defs: dict) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in tree_leaves(defs))


def cache_bytes(cfg: ArchConfig, *, batch: int, max_len: int) -> int:
    """Device bytes of the contiguous layout: every slot owns max_len rows."""
    return _defs_bytes(cache_defs(cfg, batch=batch, max_len=max_len))


def paged_keys(cfg: ArchConfig) -> tuple[str, ...]:
    """Cache leaves whose SEQUENCE axis (axis 2) the paged pool pages.  What
    is O(1) in the sequence stays per slot: the SSM conv/state (recurrent:
    ssm pages nothing, hybrid only its shared-attention K/V) and whisper's
    cross K/V (fixed at encoder_seq: audio pages its decoder's
    self-attention K/V)."""
    f = cfg.family
    if f in ("ssm", "hybrid"):
        return ("shared_k", "shared_v") if f == "hybrid" else ()
    if f in ("dense", "vlm", "moe", "audio"):
        return ("c", "krope") if cfg.mla is not None else ("k", "v")
    raise ValueError(f"unknown family {f!r}")


def page_defs(cfg: ArchConfig, *, num_pages: int, page_size: int,
              kv_quant: str | None = None) -> dict:
    """The paged layout of the sequence leaves: ``(lead, num_pages,
    page_size, ...)``, one physical-page axis shared by every slot in place
    of the per-slot (batch, seq) rectangle.  Page 0 is the pool's scratch
    page.

    ``kv_quant="int8"`` stores each payload as int8 beside an f32
    ``{key}_scale`` leaf of the payload's shape without its feature (last)
    axis: one symmetric scale a (page, row, head).  The scales ride the
    payload's page axis, so a copy, zeroing or swap of pages treats them as
    more paged leaves."""
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unsupported kv_quant {kv_quant!r}")
    defs = cache_defs(cfg, batch=num_pages, max_len=page_size)
    out = {}
    for key in paged_keys(cfg):
        d = defs[key]
        logical = (d.logical[0], None) + d.logical[2:]  # the page axis is not sharded
        if kv_quant == "int8":
            out[key] = ParamDef(d.shape, logical, init="zeros", dtype=torch.int8)
            out[f"{key}_scale"] = ParamDef(d.shape[:-1], logical[:-1], init="zeros",
                                           dtype=torch.float32)
        else:
            out[key] = ParamDef(d.shape, logical, init="zeros", dtype=d.dtype)
    return out


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of each row over the feature (last) axis,
    the JAX package's bytes: ``scale = max(amax, 1e-8) / 127``, then
    ``round(x / scale)`` half to even, clipped to +-127.  Both divisions
    are by tensors (a Python divisor becomes a product with its reciprocal
    on the card, one rounding more).  A row holding a NaN gets a NaN scale,
    which the pool's fault hygiene watches, and payloads of 0 where ``x /
    scale`` is NaN, as the JAX package's conversion gives.  Returns (q int8,
    scale f32 of ``x.shape[:-1]``)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.maximum(amax, torch.full((), 1e-8, device=x.device)) / torch.full(
        (), 127.0, device=x.device)
    r = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_kv``: ``q * scale`` over the feature axis."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def paged_cache_bytes(cfg: ArchConfig, *, batch: int, num_pages: int, page_size: int,
                      max_blocks: int, kv_quant: str | None = None) -> int:
    """Device bytes of the paged layout: the page leaves (int8 payloads and
    f32 scales under ``kv_quant``), the per-slot unpaged leaves (SSM
    conv/state, whisper's cross K/V: none depends on max_len), and the
    int32 page table."""
    unpaged = {k: d for k, d in cache_defs(cfg, batch=batch, max_len=1).items()
               if k not in paged_keys(cfg)}
    return (_defs_bytes(page_defs(cfg, num_pages=num_pages, page_size=page_size,
                                  kv_quant=kv_quant))
            + _defs_bytes(unpaged) + batch * max_blocks * 4)
