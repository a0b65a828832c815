"""Per-family transformer blocks (train/prefill/chunk/decode bodies).

Ported so far: the dense / vlm block (pre-norm GQA attention + SwiGLU or
GELU MLP).  The MoE, MLA, SSM, hybrid and encoder-decoder blocks come with
their families (ROADMAP Queue A item 8).

Every train/prefill body returns ``(x, aux)`` or ``(x, cache slices)`` as in
the JAX package; chunk and decode bodies consume the layer's cache slices
and write them in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    gqa_chunk_apply,
    gqa_decode_apply,
    gqa_defs,
    gqa_project_qkv,
    layernorm,
    layernorm_defs,
    mlp_apply,
    mlp_defs,
    rmsnorm,
    rmsnorm_defs,
    run_attention,
)
from repro_torch.models.quant import qeinsum


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Norm dispatch (whisper uses LayerNorm, everything else RMSNorm)
# ---------------------------------------------------------------------------
def norm_defs(cfg: ArchConfig, dim: int | None = None) -> dict:
    dim = dim or cfg.d_model
    return layernorm_defs(dim) if cfg.family == "audio" else rmsnorm_defs(dim)


def apply_norm(cfg: ArchConfig, p, x):
    if cfg.family == "audio":
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Dense (also VLM backbone)
# ---------------------------------------------------------------------------
def dense_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": norm_defs(cfg),
        "attn": gqa_defs(cfg),
        "ln2": norm_defs(cfg),
        "mlp": mlp_defs(cfg),
    }


def gqa_full(p, x, cfg: ArchConfig, *, causal: bool, rope: bool):
    """GQA over the full sequence; returns (out, (k, v)) for the cache."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = gqa_project_qkv(p, x, cfg, positions, rope=rope)
    out = run_attention(cfg, q, k, v, causal=causal)
    return qeinsum("bshe,hed->bsd", out, p["wo"]), (k, v)


def dense_block_apply(p, x, cfg: ArchConfig):
    x = x + gqa_full(p["attn"], apply_norm(cfg, p["ln1"], x), cfg, causal=True, rope=True)[0]
    x = x + mlp_apply(p["mlp"], apply_norm(cfg, p["ln2"], x), cfg)
    return x, _zero(x)


def dense_block_prefill(p, x, cfg: ArchConfig):
    a, (k, v) = gqa_full(p["attn"], apply_norm(cfg, p["ln1"], x), cfg, causal=True, rope=True)
    x = x + a
    x = x + mlp_apply(p["mlp"], apply_norm(cfg, p["ln2"], x), cfg)
    return x, (k, v)


def dense_block_chunk(p, x, cache, pos, cfg: ArchConfig):
    """Chunked-prefill and verify body: T tokens a row appended at ``pos``."""
    k_cache, v_cache = cache
    a, k_cache, v_cache = gqa_chunk_apply(
        p["attn"], apply_norm(cfg, p["ln1"], x), k_cache, v_cache, pos, cfg
    )
    x = x + a
    x = x + mlp_apply(p["mlp"], apply_norm(cfg, p["ln2"], x), cfg)
    return x, (k_cache, v_cache)


def dense_block_decode(p, x, cache, pos, cfg: ArchConfig):
    k_cache, v_cache = cache
    a, k_cache, v_cache = gqa_decode_apply(
        p["attn"], apply_norm(cfg, p["ln1"], x), k_cache, v_cache, pos, cfg
    )
    x = x + a
    x = x + mlp_apply(p["mlp"], apply_norm(cfg, p["ln2"], x), cfg)
    return x, (k_cache, v_cache)
