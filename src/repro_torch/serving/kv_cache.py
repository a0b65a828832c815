"""Decode-cache definitions of the port's families.

  GQA families    k/v: (L, B, S, KV, hd)                      in ``cfg.kv_dtype or cfg.dtype``
  MLA (deepseek)  c: (L, B, S, r), krope: (L, B, S, rope_d)   compressed, same type
  SSM (mamba2)    conv: (L, B, W-1, d_inner+2N) same type, state: (L, B, H, P, N) f32
  hybrid (zamba2) the SSM leaves + shared-attention k/v: (applications, B, S, KV, hd)
  audio (whisper) k/v: (L, B, S, KV, hd) + cross_k/cross_v: (L, B, encoder_seq, KV, hd),
                  the cross leaves fixed at the encoder's frames, whatever S

ParamDef trees, as in the JAX package, so the cache is initialised by the
same machinery as the weights.  The paged layout and its int8 pages
(``page_defs``, ``quantize_kv``) come with the paged pool (ROADMAP Queue A
item 10), where ``paged_keys`` gives the leaves with a sequence axis to
page.
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
    """Cache leaves whose SEQUENCE axis (axis 2) the paged pool (ROADMAP
    Queue A item 10) will page.  What is O(1) in the sequence stays per
    slot: the SSM conv/state (recurrent: ssm pages nothing, hybrid only its
    shared-attention K/V) and whisper's cross K/V (fixed at encoder_seq:
    audio pages its decoder's self-attention K/V)."""
    f = cfg.family
    if f in ("ssm", "hybrid"):
        return ("shared_k", "shared_v") if f == "hybrid" else ()
    if f in ("dense", "vlm", "moe", "audio"):
        return ("c", "krope") if cfg.mla is not None else ("k", "v")
    raise ValueError(f"unknown family {f!r}")
