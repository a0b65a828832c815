"""Per-family transformer blocks (train/prefill/chunk/decode bodies).

  dense / vlm       pre-norm GQA attention + (SwiGLU) MLP
  moe               GQA attention + top-k MoE FFN (+ shared experts): the
                    dense bodies, the FFN chosen by the block's params
  deepseek (moe)    MLA attention + dense MLP (first_k layers) or MoE
  ssm               Mamba2 (SSD) block
  hybrid (zamba2)   Mamba2 stack + ONE weight-shared attention block applied
                    every ``attn_every`` layers (input = concat(x, x0) → proj)
  audio (whisper)   enc-dec: bidirectional encoder blocks + causal decoder
                    blocks with cross-attention; LayerNorm + GELU

Every train/prefill body returns ``(x, aux)`` or ``(x, cache slices)`` as in
the JAX package; chunk and decode bodies consume the layer's cache slices
and write them in place.  The attention decode bodies take ``capacity``, the
positions of the whole cache, where the cache may be the rank's slice of
them on a mesh (``layers.seq_split``); the Mamba2 decode body reads its
split from its leaves.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    gqa_chunk_apply,
    gqa_cross_apply,
    gqa_cross_decode,
    gqa_decode_apply,
    gqa_defs,
    gqa_out,
    gqa_project_qkv,
    layernorm,
    layernorm_defs,
    mla_apply,
    mla_chunk_apply,
    mla_decode_apply,
    mla_defs,
    mla_prefill_attn,
    mlp_apply,
    mlp_defs,
    rmsnorm,
    rmsnorm_defs,
    run_attention,
)
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.models.params import ParamDef
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
    return gqa_out(p, out, cfg), (k, v)


def _ffn(p, x, cfg: ArchConfig):
    """(x + FFN(ln2(x)), aux): the block's dense MLP (aux 0), or its MoE
    and the MoE's load-balance loss."""
    h = apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        y, aux = moe_apply(p["moe"], h, cfg)
        return x + y, aux
    return x + mlp_apply(p["mlp"], h, cfg), _zero(x)


def dense_block_apply(p, x, cfg: ArchConfig):
    """The GQA block, with its dense MLP or, for granite-moe, its MoE (the
    JAX package's ``dense_block_*`` and ``moe_block_*`` bodies, by the
    block's params)."""
    x = x + gqa_full(p["attn"], apply_norm(cfg, p["ln1"], x), cfg, causal=True, rope=True)[0]
    return _ffn(p, x, cfg)


def dense_block_prefill(p, x, cfg: ArchConfig):
    a, (k, v) = gqa_full(p["attn"], apply_norm(cfg, p["ln1"], x), cfg, causal=True, rope=True)
    return _ffn(p, x + a, cfg)[0], (k, v)


def dense_block_chunk(p, x, cache, pos, cfg: ArchConfig):
    """Chunked-prefill and verify body: T tokens a row appended at ``pos``."""
    k_cache, v_cache = cache
    a, k_cache, v_cache = gqa_chunk_apply(
        p["attn"], apply_norm(cfg, p["ln1"], x), k_cache, v_cache, pos, cfg
    )
    return _ffn(p, x + a, cfg)[0], (k_cache, v_cache)


def dense_block_decode(p, x, cache, pos, cfg: ArchConfig, capacity: int | None = None):
    k_cache, v_cache = cache
    a, k_cache, v_cache = gqa_decode_apply(
        p["attn"], apply_norm(cfg, p["ln1"], x), k_cache, v_cache, pos, cfg, capacity=capacity
    )
    return _ffn(p, x + a, cfg)[0], (k_cache, v_cache)


def moe_block_defs(cfg: ArchConfig) -> dict:
    """granite-moe's block: the GQA block with a MoE for its MLP; its bodies
    are the ``dense_block_*`` ones."""
    return {
        "ln1": norm_defs(cfg),
        "attn": gqa_defs(cfg),
        "ln2": norm_defs(cfg),
        "moe": moe_defs(cfg),
    }


# ---------------------------------------------------------------------------
# DeepSeek (MLA attention; a dense MLP in the first_k_dense layers, a MoE
# after).  One set of bodies, the FFN chosen by the block's params (the JAX
# package's ``mla_dense_block_*`` and ``mla_moe_block_*``).
# ---------------------------------------------------------------------------
def mla_dense_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": norm_defs(cfg),
        "attn": mla_defs(cfg),
        "ln2": norm_defs(cfg),
        "mlp": mlp_defs(cfg),
    }


def mla_moe_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": norm_defs(cfg),
        "attn": mla_defs(cfg),
        "ln2": norm_defs(cfg),
        "moe": moe_defs(cfg),
    }


def mla_block_apply(p, x, cfg: ArchConfig):
    x = x + mla_apply(p["attn"], apply_norm(cfg, p["ln1"], x), cfg, causal=True)
    return _ffn(p, x, cfg)


def mla_block_prefill(p, x, cfg: ArchConfig):
    """The block with the compressed (c, k_rope) cache rows it produces."""
    a, cache = mla_prefill_attn(p["attn"], apply_norm(cfg, p["ln1"], x), cfg)
    return _ffn(p, x + a, cfg)[0], cache


def mla_block_chunk(p, x, cache, pos, cfg: ArchConfig):
    c, krope = cache
    a, c, krope = mla_chunk_apply(p["attn"], apply_norm(cfg, p["ln1"], x), c, krope, pos, cfg)
    return _ffn(p, x + a, cfg)[0], (c, krope)


def mla_block_decode(p, x, cache, pos, cfg: ArchConfig, capacity: int | None = None):
    c, krope = cache
    a, c, krope = mla_decode_apply(p["attn"], apply_norm(cfg, p["ln1"], x), c, krope, pos, cfg,
                                   capacity=capacity)
    return _ffn(p, x + a, cfg)[0], (c, krope)


# ---------------------------------------------------------------------------
# SSM (mamba2) and hybrid (zamba2)
# ---------------------------------------------------------------------------
def ssm_block_defs(cfg: ArchConfig) -> dict:
    return {"ln": norm_defs(cfg), "mamba": ssm_mod.mamba_defs(cfg)}


def ssm_block_apply(p, x, cfg: ArchConfig):
    return x + ssm_mod.mamba_apply(p["mamba"], apply_norm(cfg, p["ln"], x), cfg), _zero(x)


def ssm_block_prefill(p, x, cfg: ArchConfig):
    """The block with the (conv tail, f32 state) it leaves: the prefill body
    the JAX package writes inline in ``model.prefill``."""
    y, tail, h = ssm_mod.mamba_prefill_apply(p["mamba"], apply_norm(cfg, p["ln"], x), cfg)
    return x + y, (tail, h.to(torch.float32))


def ssm_block_chunk(p, x, cache, pos, cfg: ArchConfig):
    """Chunk body (``pos`` unused: the SSM carries state, not positions); the
    layer's (conv, state) slices are written in place."""
    conv, state = cache
    y, new_conv, new_state = ssm_mod.mamba_chunk_apply(
        p["mamba"], apply_norm(cfg, p["ln"], x), conv, state, cfg)
    conv.copy_(new_conv)
    state.copy_(new_state)
    return x + y, cache


def ssm_block_verify(p, x, cache, pos, cfg: ArchConfig):
    """Speculative-verify body: like ``ssm_block_chunk``, but the layer's
    cache is left as it is and the second output is the
    ``ssm.VerifyCarry`` that ``ssm.mamba_verify_commit`` rolls it forward
    with once the accepted counts are known."""
    conv, state = cache
    y, carry = ssm_mod.mamba_verify_apply(p["mamba"], apply_norm(cfg, p["ln"], x), conv, state,
                                          cfg)
    return x + y, carry


def ssm_block_decode(p, x, cache, pos, cfg: ArchConfig):
    conv, state = cache
    y, new_conv, new_state = ssm_mod.mamba_decode_apply(
        p["mamba"], apply_norm(cfg, p["ln"], x), conv, state, cfg)
    conv.copy_(new_conv)
    state.copy_(new_state)
    return x + y, cache


def shared_attn_defs(cfg: ArchConfig) -> dict:
    """Zamba2's weight-shared global attention block (one weight set)."""
    d = cfg.d_model
    return {
        "w_in": ParamDef((2 * d, d), (None, "embed")),  # concat(x, x0) → d
        "ln1": norm_defs(cfg),
        "attn": gqa_defs(cfg),
        "ln2": norm_defs(cfg),
        "mlp": mlp_defs(cfg),
        "w_out": ParamDef((d, d), ("embed", None)),
    }


def _shared_in(p, x, x0):
    return qeinsum("bsd,de->bse", torch.cat([x, x0], dim=-1), p["w_in"])


def _shared_out(p, x, inp, a, cfg: ArchConfig):
    y = inp + a
    y = y + mlp_apply(p["mlp"], apply_norm(cfg, p["ln2"], y), cfg)
    return x + qeinsum("bse,ed->bsd", y, p["w_out"])


def shared_attn_apply(p, x, x0, cfg: ArchConfig):
    return shared_attn_prefill(p, x, x0, cfg)[0]


def shared_attn_prefill(p, x, x0, cfg: ArchConfig):
    """The shared block over a whole prompt with the (k, v) it leaves: the
    body the JAX package writes inline in ``model.prefill``."""
    inp = _shared_in(p, x, x0)
    a, kv = gqa_full(p["attn"], apply_norm(cfg, p["ln1"], inp), cfg, causal=True, rope=True)
    return _shared_out(p, x, inp, a, cfg), kv


def shared_attn_chunk(p, x, x0, k_cache, v_cache, pos, cfg: ArchConfig):
    inp = _shared_in(p, x, x0)
    a, k_cache, v_cache = gqa_chunk_apply(
        p["attn"], apply_norm(cfg, p["ln1"], inp), k_cache, v_cache, pos, cfg)
    return _shared_out(p, x, inp, a, cfg), k_cache, v_cache


def shared_attn_decode(p, x, x0, k_cache, v_cache, pos, cfg: ArchConfig,
                       capacity: int | None = None):
    inp = _shared_in(p, x, x0)
    a, k_cache, v_cache = gqa_decode_apply(
        p["attn"], apply_norm(cfg, p["ln1"], inp), k_cache, v_cache, pos, cfg,
        capacity=capacity)
    return _shared_out(p, x, inp, a, cfg), k_cache, v_cache


# ---------------------------------------------------------------------------
# Whisper encoder / decoder blocks
# ---------------------------------------------------------------------------
def enc_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": norm_defs(cfg),
        "attn": gqa_defs(cfg),
        "ln2": norm_defs(cfg),
        "mlp": mlp_defs(cfg),
    }


def enc_block_apply(p, x, cfg: ArchConfig):
    """Bidirectional self-attention (no mask, no RoPE), then the GELU MLP."""
    x = x + gqa_full(p["attn"], apply_norm(cfg, p["ln1"], x), cfg, causal=False, rope=False)[0]
    return _ffn(p, x, cfg)


def dec_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": norm_defs(cfg),
        "self_attn": gqa_defs(cfg),
        "ln_x": norm_defs(cfg),
        "cross_attn": gqa_defs(cfg, cross=True),
        "ln2": norm_defs(cfg),
        "mlp": mlp_defs(cfg),
    }


def _cross_kv(p, enc, cfg: ArchConfig):
    """The cross-attention's (k, v) over the encoder output enc (B, S_enc, D):
    (B, S_enc, KV, hd) each.  ``prefill`` and ``model.encoder_cross_cache``
    both take them from here, so both give the same bits."""
    k = qeinsum("bsd,dhe->bshe", enc, p["wk"])
    v = qeinsum("bsd,dhe->bshe", enc, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    return k, v


def dec_block_apply(p, x, enc, cfg: ArchConfig):
    x = x + gqa_full(p["self_attn"], apply_norm(cfg, p["ln1"], x), cfg, causal=True,
                     rope=False)[0]
    kv = _cross_kv(p["cross_attn"], enc, cfg)
    x = x + gqa_cross_apply(p["cross_attn"], apply_norm(cfg, p["ln_x"], x), kv, cfg)
    return _ffn(p, x, cfg)


def dec_block_prefill(p, x, enc, cfg: ArchConfig):
    """The decoder block over a prompt, with the cache rows it produces: the
    self-attention's (k, v) and the cross-attention's (cross_k, cross_v)."""
    a, (k, v) = gqa_full(p["self_attn"], apply_norm(cfg, p["ln1"], x), cfg, causal=True,
                         rope=False)
    x = x + a
    ck, cv = _cross_kv(p["cross_attn"], enc, cfg)
    x = x + gqa_cross_apply(p["cross_attn"], apply_norm(cfg, p["ln_x"], x), (ck, cv), cfg)
    return _ffn(p, x, cfg)[0], (k, v, ck, cv)


def dec_block_chunk(p, x, cache, pos, cfg: ArchConfig):
    """Decoder chunk: causal self-attention over the cache (the chunk's K/V
    written in place at ``pos``) and cross-attention against the static,
    precomputed encoder K/V, which stay as they are."""
    k_cache, v_cache, ck, cv = cache
    a, k_cache, v_cache = gqa_chunk_apply(
        p["self_attn"], apply_norm(cfg, p["ln1"], x), k_cache, v_cache, pos, cfg, rope=False)
    x = x + a
    x = x + gqa_cross_apply(p["cross_attn"], apply_norm(cfg, p["ln_x"], x), (ck, cv), cfg)
    return _ffn(p, x, cfg)[0], (k_cache, v_cache, ck, cv)


def dec_block_decode(p, x, cache, pos, cfg: ArchConfig, capacity: int | None = None):
    """One token a row; the cross-attention one query against the static
    encoder K/V (``gqa_cross_decode``: on one device wq + bq, the
    attention, wo, as in the JAX package)."""
    k_cache, v_cache, ck, cv = cache
    a, k_cache, v_cache = gqa_decode_apply(
        p["self_attn"], apply_norm(cfg, p["ln1"], x), k_cache, v_cache, pos, cfg, rope=False,
        capacity=capacity)
    x = x + a
    x = x + gqa_cross_decode(p["cross_attn"], apply_norm(cfg, p["ln_x"], x), ck, cv, cfg)
    return _ffn(p, x, cfg)[0], (k_cache, v_cache, ck, cv)


# ---------------------------------------------------------------------------
# Sinusoidal positions (whisper enc/dec — length-agnostic, no params)
# ---------------------------------------------------------------------------
def sinusoid_positions(seq: int, dim: int, offset=0, device=None) -> torch.Tensor:
    """The f32 table of positions offset..offset+seq-1: sin in the even
    columns, cos in the odd ones.  ``offset`` is an int, giving (seq, dim),
    or a (B,) tensor of positions, one a row, giving (B, seq, dim) on its
    device.  The frequency factor is the JAX package's f32 one: log(10000)
    in f32, divided by ``dim`` as a tensor (CUDA divides by a Python number
    through its reciprocal); everything is built on the device, so a captured
    tick copies nothing from the host."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
        steps = offset.reshape(-1, 1) + torch.arange(seq, device=device)
    else:
        steps = torch.arange(seq, device=device) + offset
    pos = steps.to(torch.float32)[..., None]
    base = torch.full((), 10000.0, dtype=torch.float32, device=device)
    width = torch.full((), dim, dtype=torch.float32, device=device)
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-torch.log(base) / width))
    angles = pos * div
    return torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1).flatten(-2)
