"""Model API: param_defs / init_model / forward / prefill / decode_step /
prefill_chunk / decode_verify / commit_verify.

Ported so far: the dense and vlm families.  The other families (moe,
deepseek, ssm, hybrid, audio) and the loss raise ``NotImplementedError``
until they are ported (ROADMAP Queue A item 8).

Decode, chunked prefill and verify take one position per row (an int for
all rows, or a (B,) tensor), where the JAX package takes a scalar and maps
the call over a pool's slots with ``vmap``.

Parameters are stacked over layers as in the JAX package (a leading
"layers" axis on every block leaf), so the JAX package's parameter trees
carry over as they are (``models.params.params_from_numpy``).  The stack is
walked by a Python loop: ``lax.scan`` and remat have no counterpart the
serving path needs.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.layers import embed_apply, embed_defs, unembed_apply
from repro_torch.models.params import ParamDef, init_params, stacked, tree_leaves, tree_map
from repro_torch.models.quant import (
    QUANT_KEYS,
    QuantTensor,
    contract_axes,
    layer_of,
    quantize_weight,
)

_PORTED = ("dense", "vlm")


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue A item 8); "
            f"ported: {_PORTED}")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------
def param_defs(cfg: ArchConfig) -> dict:
    _require_ported(cfg)
    return {
        "embed": embed_defs(cfg),
        "final_norm": T.norm_defs(cfg),
        "blocks": stacked(cfg.num_layers, T.dense_block_defs(cfg)),
    }


def init_model(cfg: ArchConfig, generator: torch.Generator, device=None, *,
               quantize: bool = False):
    """Random parameters from ``generator`` on ``device`` (``None`` means the
    card).  A stacked leaf is drawn one layer at a time into its stacked
    tensor; with ``quantize`` each layer of a projection weight is quantized
    as soon as it is drawn, so no full-precision copy of the stack exists.
    The numbers drawn do not depend on ``quantize``: the quantized model is
    the full-precision one, quantized."""
    dev = resolve_device(device)

    def draw(key: str, d: ParamDef):
        if d.logical[:1] != ("layers",):
            return init_params(d, generator, dev)
        one = dataclasses.replace(d, shape=d.shape[1:], logical=d.logical[1:])
        quant = quantize and key in QUANT_KEYS
        out = None
        for i in range(d.shape[0]):
            w = init_params(one, generator, dev)
            if quant:
                w = quantize_weight(w, lead=0, n_contract=contract_axes(key, w.dim()))
                if out is None:
                    out = QuantTensor(
                        torch.empty((d.shape[0], *w.q.shape), dtype=w.q.dtype, device=dev),
                        torch.empty((d.shape[0], *w.scale.shape), dtype=w.scale.dtype,
                                    device=dev))
                out.q[i] = w.q
                out.scale[i] = w.scale
            else:
                if out is None:
                    out = torch.empty(d.shape, dtype=w.dtype, device=dev)
                out[i] = w
        return out

    def walk(key, d):
        if isinstance(d, dict):
            return {k: walk(k, v) for k, v in d.items()}
        return draw(key, d)

    return walk("", param_defs(cfg))


# ---------------------------------------------------------------------------
# The layer stack: a Python loop over layers
# ---------------------------------------------------------------------------
def _stack_len(stack) -> int:
    leaf = tree_leaves(stack)[0]
    return (leaf.q if isinstance(leaf, QuantTensor) else leaf).shape[0]


def _layer(stack, i: int):
    return tree_map(lambda t: layer_of(t, i), stack)


def run_stack(stack, x, body, cfg: ArchConfig):
    """body(p, x) -> (x, aux).  Returns (x, aux summed over layers)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(_stack_len(stack)):
        x, a = body(_layer(stack, i), x)
        aux = aux + a
    return x, aux


def run_stack_prefill(stack, x, body, cfg: ArchConfig):
    """body(p, x) -> (x, cache slices).  Returns (x, stacked cache)."""
    outs = []
    for i in range(_stack_len(stack)):
        x, c = body(_layer(stack, i), x)
        outs.append(c)
    return x, tuple(torch.stack(ts) for ts in zip(*outs))


def run_stack_decode(stack, caches, x, body, pos, cfg: ArchConfig):
    """body(p, x, cache, pos) -> (x, cache).  ``caches`` is a tuple of
    stacked tensors; each layer writes its slices in place."""
    for i in range(_stack_len(stack)):
        x, _ = body(_layer(stack, i), x, tuple(c[i] for c in caches), pos)
    return x, caches


# ---------------------------------------------------------------------------
# Embedding front
# ---------------------------------------------------------------------------
def _embed_tokens(params, tokens, cfg: ArchConfig, frontend_embeds=None):
    x = embed_apply(params["embed"], tokens, cfg)
    if cfg.family == "vlm" and frontend_embeds is not None:
        fs = cfg.frontend_seq
        x = torch.cat([frontend_embeds.to(x.dtype), x[:, fs:]], dim=1)
    return x


# ---------------------------------------------------------------------------
# Forward → final hidden states; prefill → (last logits, cache); decode
# ---------------------------------------------------------------------------
def forward(params, tokens, cfg: ArchConfig, frontend_embeds=None):
    _require_ported(cfg)
    x = _embed_tokens(params, tokens, cfg, frontend_embeds)
    x, aux = run_stack(params["blocks"], x, partial(T.dense_block_apply, cfg=cfg), cfg)
    return T.apply_norm(cfg, params["final_norm"], x), aux


def prefill(params, tokens, cfg: ArchConfig, frontend_embeds=None):
    """tokens: (B, S) → (last-position logits (B, V) f32, cache {"k", "v"}
    of shape (L, B, S, KV, hd))."""
    _require_ported(cfg)
    x = _embed_tokens(params, tokens, cfg, frontend_embeds)
    x, (k, v) = run_stack_prefill(params["blocks"], x, partial(T.dense_block_prefill, cfg=cfg),
                                  cfg)
    cache: dict[str, Any] = {"k": k, "v": v}
    hidden = T.apply_norm(cfg, params["final_norm"], x)
    logits = unembed_apply(params["embed"], hidden[:, -1:], cfg)[:, 0]
    return _mask_pad_logits(logits, cfg).to(torch.float32), cache


def _positions(pos, batch: int, device) -> torch.Tensor:
    """An int or a (B,) tensor → (B,) int64 on ``device``; a tensor already
    there is not copied (a captured step passes its static buffer)."""
    return torch.as_tensor(pos, device=device).to(torch.int64).reshape(-1).expand(batch)


def decode_step(params, cache, token, pos, cfg: ArchConfig):
    """token: (B, 1) integers; pos: the position each row writes, an int
    for all rows or a (B,) tensor, one per row (the JAX package takes a
    scalar and maps the step over a pool's slots).  The cache is written in
    place and returned."""
    _require_ported(cfg)
    b = token.shape[0]
    pos = _positions(pos, b, token.device)
    x = embed_apply(params["embed"], token, cfg)
    x, (k, v) = run_stack_decode(params["blocks"], (cache["k"], cache["v"]), x,
                                 partial(T.dense_block_decode, cfg=cfg), pos, cfg)
    cache = {"k": k, "v": v}
    hidden = T.apply_norm(cfg, params["final_norm"], x)
    logits = unembed_apply(params["embed"], hidden, cfg)[:, 0]
    return _mask_pad_logits(logits, cfg).to(torch.float32), cache


# ---------------------------------------------------------------------------
# Chunked prefill and speculative verify
# ---------------------------------------------------------------------------
def _chunk_forward(params, cache, tokens, pos, cfg: ArchConfig, frontend_embeds=None):
    """The chunk body shared by ``prefill_chunk`` and ``decode_verify``: T
    tokens a row against a full-capacity decode cache at positions
    [pos[b], pos[b]+T).  Returns (final hidden states before the norm,
    (B, T, D); the cache, written in place)."""
    _require_ported(cfg)
    b, t = tokens.shape
    pos = _positions(pos, b, tokens.device)
    x = embed_apply(params["embed"], tokens, cfg)
    if cfg.family == "vlm" and frontend_embeds is not None:
        steps = torch.arange(t, device=x.device)
        # the frontend stub is padded to cache capacity; the slice starts at
        # pos clamped as ``dynamic_slice`` clamps, the selection does not
        start = torch.clamp(pos, 0, frontend_embeds.shape[1] - t)
        rows = torch.arange(b, device=x.device)[:, None]
        fe = frontend_embeds[rows, start[:, None] + steps]
        sel = (pos[:, None] + steps)[..., None] < cfg.frontend_seq
        x = torch.where(sel, fe.to(x.dtype), x)
    x, (k, v) = run_stack_decode(params["blocks"], (cache["k"], cache["v"]), x,
                                 partial(T.dense_block_chunk, cfg=cfg), pos, cfg)
    return x, {"k": k, "v": v}


def prefill_chunk(params, cache, tokens, pos, cfg: ArchConfig, frontend_embeds=None):
    """One chunk of T prompt tokens a row against a full-capacity decode
    cache (``cache_defs`` layout, zero-initialised) at positions
    [pos, pos+T).  Successive chunks compose to ``prefill``; attention masks
    the dead rows past the written prefix.  For vlm, ``frontend_embeds`` is
    padded to cache capacity on the sequence axis.  Returns (last-position
    logits (B, V) f32, cache written in place)."""
    x, cache = _chunk_forward(params, cache, tokens, pos, cfg, frontend_embeds)
    hidden = T.apply_norm(cfg, params["final_norm"], x)
    logits = unembed_apply(params["embed"], hidden[:, -1:], cfg)[:, 0]
    return _mask_pad_logits(logits, cfg).to(torch.float32), cache


def decode_verify(params, cache, tokens, pos, cfg: ArchConfig, frontend_embeds=None):
    """Score T candidate tokens a row in one pass at positions [pos, pos+T):
    the last committed next-input token, then T-1 drafts.  Returns logits
    for every position, (B, T, V) f32: logits[:, j] is the next-token
    distribution after tokens[:, :j+1].  The K/V rows of rejected
    candidates are dead data past the committed prefix (see
    ``layers.attention_chunk``), so attention caches need no rollback."""
    x, cache = _chunk_forward(params, cache, tokens, pos, cfg, frontend_embeds)
    hidden = T.apply_norm(cfg, params["final_norm"], x)
    logits = unembed_apply(params["embed"], hidden, cfg)
    return _mask_pad_logits(logits, cfg).to(torch.float32), cache


def commit_verify(cache, accepted, cfg: ArchConfig):
    """Resolve a ``decode_verify`` cache to the accepted prefix: the identity
    for attention caches (rollback is positional).  The ssm/hybrid state
    snapshots come with those families (ROADMAP Queue A item 8)."""
    _require_ported(cfg)
    return cache


def _mask_pad_logits(logits, cfg: ArchConfig):
    v = logits.shape[-1]
    if v > cfg.vocab_size:
        keep = torch.arange(v, device=logits.device) < cfg.vocab_size
        return torch.where(keep, logits, torch.full_like(logits, -1e30))
    return logits
