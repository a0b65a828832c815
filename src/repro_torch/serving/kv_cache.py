"""Decode-cache definitions of the port's families.

  GQA families    k/v: (L, B, S, KV, hd)                      in ``cfg.kv_dtype or cfg.dtype``
  MLA (deepseek)  c: (L, B, S, r), krope: (L, B, S, rope_d)   compressed, same type

ParamDef trees, as in the JAX package, so the cache is initialised by the
same machinery as the weights.  The SSM, hybrid and audio layouts come
with their families (ROADMAP Queue A item 8); the paged layout and its int8
pages (``page_defs``, ``quantize_kv``) with the paged pool (item 10).
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamDef, tree_leaves


def _kv(num_layers: int, b: int, s: int, kv: int, hd: int, dtype) -> ParamDef:
    return ParamDef(
        (num_layers, b, s, kv, hd),
        ("layers", "batch", "kv_seq", "kv_heads", None),
        init="zeros",
        dtype=dtype,
    )


def cache_defs(cfg: ArchConfig, *, batch: int, max_len: int) -> dict:
    f = cfg.family
    if f not in ("dense", "vlm", "moe"):
        raise NotImplementedError(f"the {f!r} cache layout is not ported yet "
                                  "(ROADMAP Queue A item 8)")
    l, hd, kv = cfg.num_layers, cfg.resolved_head_dim, cfg.num_kv_heads
    dt = cfg.kv_dtype or cfg.dtype
    if cfg.mla is not None:  # deepseek: the compressed cache
        m = cfg.mla
        axes = ("layers", "batch", "kv_seq", None)
        return {"c": ParamDef((l, batch, max_len, m.kv_lora_rank), axes, init="zeros", dtype=dt),
                "krope": ParamDef((l, batch, max_len, m.qk_rope_head_dim), axes, init="zeros",
                                  dtype=dt)}
    return {"k": _kv(l, batch, max_len, kv, hd, dt), "v": _kv(l, batch, max_len, kv, hd, dt)}


def _defs_bytes(defs: dict) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in tree_leaves(defs))


def cache_bytes(cfg: ArchConfig, *, batch: int, max_len: int) -> int:
    """Device bytes of the contiguous layout: every slot owns max_len rows."""
    return _defs_bytes(cache_defs(cfg, batch=batch, max_len=max_len))
