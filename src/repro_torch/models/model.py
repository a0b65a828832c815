"""Model API: param_defs / init_model / forward / prefill / decode_step /
prefill_chunk / decode_verify / commit_verify.

Every family of the JAX package: dense, and vlm (the dense stack, the
front-end's ``frontend_seq`` patch embeddings in place of the first token
positions); the moe family: granite-moe (GQA attention + MoE) and deepseek
(MLA attention; ``first_k_dense`` leading MLA + dense-MLP blocks in
``dense_blocks``, then MLA + MoE blocks in ``blocks``; the compressed
(c, k_rope) cache spans both stacks, the first ``first_k_dense`` layers of
it the dense ones'); the ssm family (a single Mamba2 stack, a per-layer
(conv, state) cache); hybrid (zamba2: segments of ``attn_every`` Mamba2
layers, each preceded by the ONE weight-shared attention block, which takes
concat(x, x0) with x0 the embedding of the call's own tokens; its
(shared_k, shared_v) cache has one entry per application); and audio
(whisper: an encoder stack over the front-end's frames, ``enc_blocks`` and
``enc_norm``, and a causal decoder stack with cross-attention in
``blocks``; sinusoidal positions on both sides; a cache of four leaves a
layer, the self-attention's (k, v), which grow with the sequence, and the
cross-attention's (cross_k, cross_v) over ``encoder_seq`` frames, which the
prompt's prefill or ``encoder_cross_cache`` fills once and nothing writes
after).

Training: ``train_loss`` (the masked mean cross-entropy of ``lm_loss``,
sequence-chunked when ``cfg.logits_chunk`` divides S, plus the MoE
load-balance loss and deepseek's multi-token-prediction head, whose
parameters ``mtp`` serving draws but never uses).  Under autograd each
layer of the stacks, and hybrid's shared block, is rematerialised as
``cfg.remat`` says (``_remat``); serving runs under
``torch.inference_mode`` and is untouched.

The paged pool's bridges (``paged_virtual_cache``, ``paged_written_blocks``,
``verify_block_span``) gather every slot's cache row through its page table
and extract the blocks a tick wrote, for all slots at once.

Decode, chunked prefill and verify take one position per row (an int for
all rows, or a (B,) tensor), where the JAX package takes a scalar and maps
the call over a pool's slots with ``vmap``.  ``commit_verify`` likewise
takes one accepted count per row.

Speculative verify on the ssm and hybrid families leaves the recurrent
leaves as they are and returns, beside them, what ``commit_verify`` needs
to roll each row forward to its accepted count in place
(``ssm.VerifyCarry`` per layer, under the key ``"verify"``); the JAX package
returns (L, B, T, ...) snapshots of every position instead.

Parameters are stacked over layers as in the JAX package (a leading
"layers" axis on every block leaf), so the JAX package's parameter trees
carry over as they are (``models.params.params_from_numpy``).  The stack is
walked by a Python loop where the JAX package scans it; hybrid's segments
need no slice of the stack (the reference's ``_stack_slice``): the shared
block runs from the stack loops' ``before`` hook.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as T
from repro_torch.core import collectives as C
from repro_torch.models.layers import (
    embed_apply,
    embed_defs,
    tp_sum,
    unembed_apply,
    vocab_split,
)
from repro_torch.models.params import ParamDef, init_params, stacked, tree_leaves, tree_map
from repro_torch.models.quant import (
    QUANT_KEYS,
    QuantTensor,
    contract_axes,
    layer_of,
    lead_axes,
    quantize_weight,
)
from repro_torch.sharding.rules import MODEL

_PORTED = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
_RECURRENT = ("ssm", "hybrid")
MOE_AUX_COEF = 0.01
MTP_WEIGHT = 0.1


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in _PORTED:
        raise ValueError(f"unknown family {cfg.family!r}; the port serves {_PORTED}")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------
def param_defs(cfg: ArchConfig) -> dict:
    _require_ported(cfg)
    defs: dict[str, Any] = {"embed": embed_defs(cfg), "final_norm": T.norm_defs(cfg)}
    if cfg.family in ("dense", "vlm"):
        defs["blocks"] = stacked(cfg.num_layers, T.dense_block_defs(cfg))
    elif cfg.family in _RECURRENT:
        defs["blocks"] = stacked(cfg.num_layers, T.ssm_block_defs(cfg))
        if cfg.family == "hybrid":
            defs["shared"] = T.shared_attn_defs(cfg)
    elif cfg.family == "audio":
        defs["enc_blocks"] = stacked(cfg.encoder_layers, T.enc_block_defs(cfg))
        defs["enc_norm"] = T.norm_defs(cfg)
        defs["blocks"] = stacked(cfg.num_layers, T.dec_block_defs(cfg))
    elif cfg.mla is None:  # moe
        defs["blocks"] = stacked(cfg.num_layers, T.moe_block_defs(cfg))
    else:  # deepseek
        k = cfg.first_k_dense
        defs["dense_blocks"] = stacked(k, T.mla_dense_block_defs(cfg))
        defs["blocks"] = stacked(cfg.num_layers - k, T.mla_moe_block_defs(cfg))
        if cfg.mtp:
            defs["mtp"] = {
                "norm_h": T.norm_defs(cfg),
                "norm_e": T.norm_defs(cfg),
                "proj": ParamDef((2 * cfg.d_model, cfg.d_model), (None, "embed")),
                "block": T.mla_dense_block_defs(cfg),
            }
    return defs


def init_model(cfg: ArchConfig, generator: torch.Generator, device=None, *,
               quantize: bool = False, keep=None):
    """Random parameters from ``generator`` on ``device`` (``None`` means the
    card).  A stacked leaf is drawn one layer at a time into its stacked
    tensor; with ``quantize`` each layer of a projection weight (all its
    experts at once) is quantized as soon as it is drawn, so no
    full-precision copy of the stack exists.
    The numbers drawn do not depend on ``quantize``: the quantized model is
    the full-precision one, quantized.  ``keep(path, leaf)``, where given,
    is what is kept of each leaf (a rank's block), called as soon as the
    leaf is drawn, with its key path: no more than one whole leaf exists
    at a time, and the numbers drawn do not depend on it either."""
    dev = resolve_device(device)

    def draw(key: str, d: ParamDef):
        quant = quantize and key in QUANT_KEYS
        if d.logical[:1] != ("layers",):  # an unstacked leaf, e.g. hybrid's shared block
            w = init_params(d, generator, dev)
            lead = lead_axes(d.logical)
            return quantize_weight(w, lead=lead, n_contract=contract_axes(
                key, w.dim() - lead)) if quant else w
        if d.shape[0] == 0:  # an empty stack (deepseek with every layer dense): nothing to draw
            return torch.empty(d.shape, dtype=d.dtype, device=dev)  # nor to quantize
        one = dataclasses.replace(d, shape=d.shape[1:], logical=d.logical[1:])
        out = None
        for i in range(d.shape[0]):
            w = init_params(one, generator, dev)
            if quant:
                lead = lead_axes(one.logical)
                w = quantize_weight(w, lead=lead, n_contract=contract_axes(key, w.dim() - lead))
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

    def walk(path, d):
        if isinstance(d, dict):
            return {k: walk(path + (k,), v) for k, v in d.items()}
        w = draw(path[-1], d)
        return w if keep is None else keep(path, w)

    return walk((), param_defs(cfg))


# ---------------------------------------------------------------------------
# The layer stacks: a Python loop over layers
# ---------------------------------------------------------------------------
def _stack_len(stack) -> int:
    leaf = tree_leaves(stack)[0]
    return (leaf.q if isinstance(leaf, QuantTensor) else leaf).shape[0]


def _layer(stack, i: int):
    return tree_map(lambda t: layer_of(t, i), stack)


def _bodies(cfg: ArchConfig):
    """The block bodies (apply, prefill, chunk, decode): the Mamba2 block's
    (ssm, and hybrid between its shared blocks), whisper's decoder block
    (its apply and prefill bodies also take the encoder output, ``enc``),
    MLA's, or the GQA block's (dense, vlm and granite-moe; each block's FFN,
    MLP or MoE, by its params)."""
    _require_ported(cfg)
    if cfg.family in _RECURRENT:
        bodies = (T.ssm_block_apply, T.ssm_block_prefill, T.ssm_block_chunk, T.ssm_block_decode)
    elif cfg.family == "audio":
        bodies = (T.dec_block_apply, T.dec_block_prefill, T.dec_block_chunk, T.dec_block_decode)
    elif cfg.mla is not None:
        bodies = (T.mla_block_apply, T.mla_block_prefill, T.mla_block_chunk, T.mla_block_decode)
    else:
        bodies = (T.dense_block_apply, T.dense_block_prefill, T.dense_block_chunk,
                  T.dense_block_decode)
    return [partial(body, cfg=cfg) for body in bodies]


def _stacks(params) -> list:
    """The layer stacks in order: deepseek's leading dense blocks, then the
    blocks every family has (whisper's encoder stack is not among them: it
    runs once, ahead of the decoder, in ``_encode_audio``)."""
    return [params[key] for key in ("dense_blocks", "blocks") if key in params]


def cache_keys(cfg: ArchConfig) -> tuple[str, ...]:
    """The decode cache's per-layer leaves: the (conv, state) pair of the
    Mamba2 layers, the compressed (c, k_rope) pair of MLA, whisper's
    decoder (k, v, cross_k, cross_v), K and V otherwise.  Hybrid's shared
    block adds (shared_k, shared_v), one entry per application."""
    if cfg.family in _RECURRENT:
        return ("conv", "state")
    if cfg.family == "audio":
        return ("k", "v", "cross_k", "cross_v")
    return ("c", "krope") if cfg.mla is not None else ("k", "v")


def _hybrid_segments(cfg: ArchConfig) -> list[tuple[int, int]]:
    """[(start, length)] mamba-layer segments, each preceded by shared attn."""
    k = cfg.attn_every
    return [(s, min(k, cfg.num_layers - s)) for s in range(0, cfg.num_layers, k)]


def _shared_before(params, cfg: ArchConfig, x0, apply):
    """Hybrid's ``before`` hook of the stack drivers: ``apply(p, x, x0, i)``,
    the i-th application of the shared block, ahead of the first layer of
    segment i; ``None`` for the other families."""
    if cfg.family != "hybrid":
        return None
    starts = {start: i for i, (start, _) in enumerate(_hybrid_segments(cfg))}

    def before(layer: int, x):
        i = starts.get(layer)
        return x if i is None else apply(params["shared"], x, x0, i)

    return before


def _walk(stacks):
    """(layer index over all stacks, that layer's params), in order."""
    layer = 0
    for stack in stacks:
        for i in range(_stack_len(stack)):
            yield layer, _layer(stack, i)
            layer += 1


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the products with no batch dimension, the
    reference's ``dots_with_no_batch_dims_saveable``, and recompute the rest.
    ``torch.einsum`` runs every product as ``bmm``, one with no batch
    dimension as a ``bmm`` over a batch of 1; attention's batched products
    (over batch and heads) are recomputed, as in the reference."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(f, cfg: ArchConfig):
    """``f`` rematerialised under ``cfg.remat`` when autograd records:
    ``"none"`` keeps every activation, ``"dots"`` only the products with no
    batch dimension (``_save_dots``), anything else (``"full"``) only the
    inputs.  Without autograd (serving) ``f`` as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return f
    if cfg.remat == "dots":
        context_fn = partial(create_selective_checkpoint_contexts, _save_dots)
    else:
        context_fn = noop_context_fn
    return lambda *args: checkpoint(f, *args, use_reentrant=False, context_fn=context_fn)


def run_stack(stacks, x, body, cfg: ArchConfig, before=None):
    """body(p, x) -> (x, aux) over the layers of ``stacks``, ``before(layer,
    x) -> x`` ahead of each (hybrid's shared block).  Each layer is
    rematerialised under ``cfg.remat`` (``_remat``).  Returns (x, aux summed
    over layers)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = _remat(body, cfg)
    for layer, p in _walk(stacks):
        if before is not None:
            x = before(layer, x)
        x, a = body(p, x)
        aux = aux + a
    return x, aux


def run_stack_prefill(stacks, x, body, cfg: ArchConfig, before=None):
    """body(p, x) -> (x, cache slices) over the layers of ``stacks``.
    Returns (x, the cache slices stacked over all layers)."""
    outs = []
    for layer, p in _walk(stacks):
        if before is not None:
            x = before(layer, x)
        x, c = body(p, x)
        outs.append(c)
    return x, tuple(torch.stack(ts) for ts in zip(*outs))


def run_stack_decode(stacks, caches, x, body, pos, cfg: ArchConfig, before=None):
    """body(p, x, cache, pos) -> (x, out) over the layers of ``stacks``.
    ``caches`` is a tuple of tensors stacked over all layers; each layer
    writes its slices in place.  Returns (x, each layer's ``out``)."""
    outs = []
    for layer, p in _walk(stacks):
        if before is not None:
            x = before(layer, x)
        x, out = body(p, x, tuple(c[layer] for c in caches), pos)
        outs.append(out)
    return x, outs


# ---------------------------------------------------------------------------
# Embedding front
# ---------------------------------------------------------------------------
def _embed_tokens(params, tokens, cfg: ArchConfig, frontend_embeds=None):
    """The prompt's embeddings.  vlm: the ``frontend_seq`` patch rows are
    concatenated ahead of x[:, frontend_seq:], as in the JAX package, so a
    prompt shorter than ``frontend_seq`` gives ``frontend_seq`` positions,
    not S.  audio: plus the sinusoid of positions 0..S-1."""
    x = embed_apply(params["embed"], tokens, cfg)
    if cfg.family == "vlm" and frontend_embeds is not None:
        fs = cfg.frontend_seq
        x = torch.cat([frontend_embeds.to(x.dtype), x[:, fs:]], dim=1)
    return _add_positions(x, cfg, 0)


def _add_positions(x, cfg: ArchConfig, pos):
    """Whisper's sinusoidal positions added to x (B, T, D) at ``pos`` (an
    int, or (B,): one a row), cast to x's type; x as it is for the other
    families."""
    if cfg.family != "audio":
        return x
    return x + T.sinusoid_positions(x.shape[1], cfg.d_model, pos, x.device).to(x.dtype)


def _encode_audio(params, cfg: ArchConfig, frontend_embeds):
    """The audio encoder pass shared by prefill and ``encoder_cross_cache``
    (one definition keeps their cross K/V the same bits): the frames plus
    their sinusoid, the encoder stack, its final norm."""
    enc = frontend_embeds.to(cfg.dtype)
    enc = enc + T.sinusoid_positions(enc.shape[1], cfg.d_model, 0, enc.device).to(enc.dtype)
    enc, _ = run_stack([params["enc_blocks"]], enc, partial(T.enc_block_apply, cfg=cfg), cfg)
    return T.apply_norm(cfg, params["enc_norm"], enc)


def encoder_cross_cache(params, cfg: ArchConfig, frontend_embeds):
    """Run the audio encoder once and return the decoder's cross K/V stacks
    (cross_k, cross_v), each (L, B, encoder_seq, KV, hd): the static cache
    leaves that chunked prefill and decode read.  A loop over the decoder
    layers where the JAX package maps ``_cross_kv`` over them."""
    enc = _encode_audio(params, cfg, frontend_embeds)
    kv = [T._cross_kv(p["cross_attn"], enc, cfg) for _, p in _walk([params["blocks"]])]
    return tuple(torch.stack(ts) for ts in zip(*kv))


def _with_encoder(body, params, cfg: ArchConfig, frontend_embeds):
    """Whisper's apply and prefill bodies take the encoder output: ``body``
    with ``enc`` bound (the JAX package's lambda); the other families'
    bodies as they are."""
    if cfg.family != "audio":
        return body
    return partial(body, enc=_encode_audio(params, cfg, frontend_embeds))


# ---------------------------------------------------------------------------
# Forward → final hidden states; prefill → (last logits, cache); decode
# ---------------------------------------------------------------------------
def forward(params, tokens, cfg: ArchConfig, frontend_embeds=None):
    """tokens: (B, S) → (final hidden states (B, S, D), the MoE load-balance
    loss summed over layers; 0 for the other families)."""
    apply, _, _, _ = _bodies(cfg)
    apply = _with_encoder(apply, params, cfg, frontend_embeds)
    x = _embed_tokens(params, tokens, cfg, frontend_embeds)
    shared = _remat(partial(T.shared_attn_apply, cfg=cfg), cfg)
    before = _shared_before(params, cfg, x, lambda p, x, x0, i: shared(p, x, x0))
    x, aux = run_stack(_stacks(params), x, apply, cfg, before)
    return T.apply_norm(cfg, params["final_norm"], x), aux


# ---------------------------------------------------------------------------
# Cross-entropy (whole-vocab or sequence-chunked) and the training loss
# ---------------------------------------------------------------------------
def _ce_block(params, hidden, labels, mask, cfg: ArchConfig):
    """CE over one block.  hidden: (B, T, D), labels/mask: (B, T).  Returns
    (nll_sum, n).  The label's logit is gathered where the reference sums
    logits times a one-hot: one nonzero term, the same value.

    On the rank's block of the vocabulary (``vocab_split``) the logits are
    its columns: the vocab padding is masked by global column, the
    log-sum-exp is the maximum over "model" (no gradient: it only shifts)
    plus the log of the sum over "model" of the exponentials, and the
    label's logit is the sum over "model" of the one held by its rank."""
    logits = unembed_apply(params["embed"], hidden, cfg).to(torch.float32)
    v = logits.shape[-1]
    split = vocab_split(params["embed"], cfg)
    start = 0 if split is None else split[1] * v
    if cfg.padded_vocab > cfg.vocab_size:  # mask the vocab-padding columns out of the lse
        cols = start + torch.arange(v, device=logits.device)
        logits = torch.where(cols < cfg.vocab_size, logits,
                             torch.full((), -1e30, dtype=logits.dtype, device=logits.device))
    if split is None:
        lse = torch.logsumexp(logits, dim=-1)
        correct = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    else:
        top = C.all_reduce_max(logits.detach().amax(dim=-1), split[0], MODEL)
        local = labels.to(torch.int64) - start
        held = (local >= 0) & (local < v)
        picked = torch.gather(logits, -1, torch.clamp(local, 0, v - 1)[..., None])[..., 0]
        sums = tp_sum(torch.stack([torch.sum(torch.exp(logits - top[..., None]), dim=-1),
                                   torch.where(held, picked, torch.zeros_like(picked))]), split)
        lse, correct = top + torch.log(sums[0]), sums[1]
    nll = (lse - correct) * mask
    return torch.sum(nll), torch.sum(mask)


def lm_loss(params, hidden, labels, cfg: ArchConfig):
    """Masked mean CE.  labels < 0 are masked out.  With ``cfg.logits_chunk``
    dividing S (and below it), the sum runs over chunks of the sequence, a
    loop where the reference scans."""
    mask = (labels >= 0).to(torch.float32)
    labels = torch.clamp_min(labels, 0)
    c = cfg.logits_chunk
    s = hidden.shape[1]
    if c and s % c == 0 and s > c:
        tot = n = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, s, c):
            t, k = _ce_block(params, hidden[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c],
                             cfg)
            tot, n = tot + t, n + k
    else:
        tot, n = _ce_block(params, hidden, labels, mask, cfg)
    return tot / torch.clamp_min(n, 1.0)


def train_loss(params, batch, cfg: ArchConfig):
    """Scalar loss + metrics for one batch: {"tokens", "labels"} (B, S), and
    for the vlm and audio families "frontend_embeds"."""
    hidden, aux = forward(params, batch["tokens"], cfg,
                          frontend_embeds=batch.get("frontend_embeds"))
    ce = lm_loss(params, hidden, batch["labels"], cfg)
    loss = ce + MOE_AUX_COEF * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp and "mtp" in params:
        mtp = params["mtp"]
        emb_next = embed_apply(params["embed"], batch["tokens"][:, 1:], cfg)
        h = T.apply_norm(cfg, mtp["norm_h"], hidden[:, :-1])
        e = T.apply_norm(cfg, mtp["norm_e"], emb_next)
        inp = torch.einsum("bsd,de->bse", torch.cat([h, e], dim=-1), mtp["proj"])
        h_mtp, _ = T.mla_block_apply(mtp["block"], inp, cfg)
        mtp_ce = lm_loss(params, h_mtp, batch["labels"][:, 1:], cfg)
        loss = loss + MTP_WEIGHT * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def prefill(params, tokens, cfg: ArchConfig, frontend_embeds=None):
    """tokens: (B, S) → (last-position logits (B, V) f32, cache): {"k", "v"}
    of shape (L, B, S, KV, hd); MLA's {"c": (L, B, S, kv_lora_rank),
    "krope": (L, B, S, qk_rope_head_dim)}; the Mamba2 layers' {"conv": (L,
    B, W-1, d_inner + 2N), "state": (L, B, H, P, N) f32}, and for hybrid
    {"shared_k", "shared_v"}: (applications, B, S, KV, hd); whisper's
    {"k", "v"} and {"cross_k", "cross_v"}: (L, B, encoder_seq, KV, hd), the
    encoder run over ``frontend_embeds`` (B, encoder_seq, D)."""
    _, body, _, _ = _bodies(cfg)
    body = _with_encoder(body, params, cfg, frontend_embeds)
    x = _embed_tokens(params, tokens, cfg, frontend_embeds)
    shared = []

    def apply_shared(p, x, x0, i):
        y, kv = T.shared_attn_prefill(p, x, x0, cfg)
        shared.append(kv)
        return y

    x, leaves = run_stack_prefill(_stacks(params), x, body, cfg,
                                  _shared_before(params, cfg, x, apply_shared))
    cache: dict[str, Any] = dict(zip(cache_keys(cfg), leaves))
    if shared:
        cache["shared_k"], cache["shared_v"] = (torch.stack(ts) for ts in zip(*shared))
    hidden = T.apply_norm(cfg, params["final_norm"], x)
    logits = unembed_apply(params["embed"], hidden[:, -1:], cfg)[:, 0]
    return _mask_pad_logits(logits, cfg).to(torch.float32), cache


def _positions(pos, batch: int, device) -> torch.Tensor:
    """An int or a (B,) tensor → (B,) int64 on ``device``, contiguous (the
    decode attention kernel reads one position a row); a (B,) tensor already
    there is not copied (a captured step passes its static buffer)."""
    pos = torch.as_tensor(pos, device=device).to(torch.int64).reshape(-1)
    return pos.expand(batch).contiguous()


def _run_cached(params, cache, x, body, pos, cfg: ArchConfig, shared_body):
    """The stack over a full-capacity decode cache, in place: ``body`` on
    each layer's slices of ``cache_keys(cfg)``, hybrid's shared block
    (``shared_body``: ``T.shared_attn_decode`` or ``T.shared_attn_chunk``)
    on its application's (shared_k, shared_v) ahead of each segment.
    Returns (x, each layer's second output)."""
    def apply_shared(p, x, x0, i):
        return shared_body(p, x, x0, cache["shared_k"][i], cache["shared_v"][i], pos, cfg)[0]

    return run_stack_decode(_stacks(params), tuple(cache[k] for k in cache_keys(cfg)), x, body,
                            pos, cfg, _shared_before(params, cfg, x, apply_shared))


def decode_step(params, cache, token, pos, cfg: ArchConfig, *, capacity: int | None = None):
    """token: (B, 1) integers; pos: the position each row writes, an int
    for all rows, a 0-d tensor, or a (B,) tensor, one per row (the JAX
    package takes a scalar and maps the step over a pool's slots).  The
    cache is written in place and returned.

    On a mesh (under ``activate_mesh``) the params may be the rank's compute
    blocks and the cache the rank's block of ``_cache_spec``: its rows of
    the batch, and its slice of the ``capacity`` positions where the
    sequence axis is split over "model" (``layers.seq_split``; ``None``: the
    cache holds every position).  The logits are gathered over "model"
    where the vocabulary is split."""
    _, _, _, body = _bodies(cfg)
    shared = partial(T.shared_attn_decode, capacity=capacity)
    if cfg.family not in _RECURRENT:
        body = partial(body, capacity=capacity)
    b = token.shape[0]
    pos = _positions(pos, b, token.device)
    x = _add_positions(embed_apply(params["embed"], token, cfg), cfg, pos)
    x, _ = _run_cached(params, cache, x, body, pos, cfg, shared)
    hidden = T.apply_norm(cfg, params["final_norm"], x)
    logits = unembed_apply(params["embed"], hidden, cfg)[:, 0]
    split = vocab_split(params["embed"], cfg)
    if split is not None:
        logits = C.all_gather(logits.to(torch.float32), split[0], MODEL, dim=-1)
    return _mask_pad_logits(logits, cfg).to(torch.float32), cache


# ---------------------------------------------------------------------------
# Chunked prefill and speculative verify
# ---------------------------------------------------------------------------
def _chunk_forward(params, cache, tokens, pos, cfg: ArchConfig, frontend_embeds=None,
                   verify: bool = False):
    """The chunk body shared by ``prefill_chunk`` and ``decode_verify``: T
    tokens a row against a full-capacity decode cache at positions
    [pos[b], pos[b]+T).  ``verify`` swaps the Mamba2 layers' body for
    ``T.ssm_block_verify``, which leaves their (conv, state) as they are.
    Returns (final hidden states before the norm, (B, T, D); each layer's
    second output: its cache slices, or with ``verify`` on the ssm and
    hybrid families its ``ssm.VerifyCarry``)."""
    _, _, body, _ = _bodies(cfg)
    if verify and cfg.family in _RECURRENT:
        body = partial(T.ssm_block_verify, cfg=cfg)
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
    x = _add_positions(x, cfg, pos)
    return _run_cached(params, cache, x, body, pos, cfg, T.shared_attn_chunk)


def prefill_chunk(params, cache, tokens, pos, cfg: ArchConfig, frontend_embeds=None):
    """One chunk of T prompt tokens a row against a full-capacity decode
    cache (``cache_defs`` layout, zero-initialised; for audio with its
    cross_k/cross_v filled up front by ``encoder_cross_cache``) at positions
    [pos, pos+T).  Successive chunks compose to ``prefill``: attention masks
    the dead rows past the written prefix, the Mamba2 layers carry their
    conv tail and state.  For vlm, ``frontend_embeds`` is padded to cache
    capacity on the sequence axis.  Returns (last-position logits (B, V)
    f32, cache written in place)."""
    x, _ = _chunk_forward(params, cache, tokens, pos, cfg, frontend_embeds)
    hidden = T.apply_norm(cfg, params["final_norm"], x)
    logits = unembed_apply(params["embed"], hidden[:, -1:], cfg)[:, 0]
    return _mask_pad_logits(logits, cfg).to(torch.float32), cache


def decode_verify(params, cache, tokens, pos, cfg: ArchConfig, frontend_embeds=None):
    """Score T candidate tokens a row in one pass at positions [pos, pos+T):
    the last committed next-input token, then T-1 drafts.  Returns logits
    for every position, (B, T, V) f32: logits[:, j] is the next-token
    distribution after tokens[:, :j+1]; and the cache.

    Attention caches (K/V, MLA's c/k_rope, hybrid's shared K/V, whisper's
    self-attention K/V) are written in place: the rows of rejected
    candidates are dead data past the committed prefix (see
    ``layers.attention_chunk``), so they need no rollback; whisper's
    cross_k/cross_v are read, never written.  The Mamba2 layers' (conv,
    state) are left as they were; the returned dict holds the same tensors
    and, under ``"verify"``, one ``ssm.VerifyCarry`` a layer, from which
    ``commit_verify`` writes each row's state after its accepted count."""
    x, outs = _chunk_forward(params, cache, tokens, pos, cfg, frontend_embeds, verify=True)
    hidden = T.apply_norm(cfg, params["final_norm"], x)
    logits = unembed_apply(params["embed"], hidden, cfg)
    if cfg.family in _RECURRENT:
        cache = dict(cache, verify=outs)
    return _mask_pad_logits(logits, cfg).to(torch.float32), cache


def commit_verify(cache, accepted, cfg: ArchConfig):
    """Resolve a ``decode_verify`` cache to the accepted prefix.

    ``accepted``: accepted drafts a in [0, K] a row (an int for all rows,
    or a (B,) tensor), i.e. a+1 tokens of the window were consumed.
    Attention caches need nothing (rollback is positional: the dense, vlm,
    moe and audio families, whose static cross K/V verify never wrote);
    the ssm/hybrid (conv, state) of row b are written, in place, as they
    stand after a[b]+1 tokens (the JAX package's snapshot at index a).  Returns the
    cache without the ``"verify"`` entry."""
    _require_ported(cfg)
    if cfg.family not in _RECURRENT:
        return cache
    cache = dict(cache)
    carries = cache.pop("verify")
    acc = _positions(accepted, cache["state"].shape[1], cache["state"].device)
    for layer, carry in enumerate(carries):
        ssm_mod.mamba_verify_commit(carry, acc, cache["conv"][layer], cache["state"][layer], cfg)
    return cache


def _mask_pad_logits(logits, cfg: ArchConfig):
    v = logits.shape[-1]
    if v > cfg.vocab_size:
        keep = torch.arange(v, device=logits.device) < cfg.vocab_size
        return torch.where(keep, logits, torch.full_like(logits, -1e30))
    return logits


# ---------------------------------------------------------------------------
# Paged-cache bridges (serving/pages.py)
# ---------------------------------------------------------------------------
# The decode and verify bodies above see a contiguous cache row per slot and
# write positions [pos, pos+T) under the positional masks of models/layers.py.
# The paged ticks reuse them unchanged: every slot's pages are gathered into a
# virtual contiguous row through its page-table row, and the written blocks
# are extracted afterwards for a scatter by page id.  Rows gathered from
# unmapped blocks (the scratch page) are garbage, but every position past a
# row's own is masked to -1e30 before the softmax, so they weigh exactly 0.
# Where the JAX package takes one slot under vmap, these take all slots.


def paged_virtual_cache(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather every slot's virtual contiguous cache row.

    pages: (lead, num_pages, page_size, *tail); table: (B, max_blocks) page
    ids → (lead, B, max_blocks * page_size, *tail), a new tensor."""
    g = pages[:, table]  # (lead, B, max_blocks, page, *tail)
    return g.reshape(g.shape[0], table.shape[0], table.shape[1] * pages.shape[2],
                     *pages.shape[3:])


def paged_written_blocks(rows: torch.Tensor, first_blk: torch.Tensor, n_blocks: int,
                         page_size: int) -> torch.Tensor:
    """Extract ``n_blocks`` whole blocks of each virtual row, row b's from
    block ``first_blk[b]`` on.

    rows: (lead, B, S, *tail); first_blk: (B,) → (lead, B, n_blocks,
    page_size, *tail).  Positions past S read as zeros, as if the rows were
    padded by the span first (the JAX package pads, so that its
    ``dynamic_slice`` never clamps a start and misaligns the blocks); no
    padded copy of the rows is made."""
    b, s = rows.shape[1], rows.shape[2]
    span = n_blocks * page_size
    at = first_blk.to(torch.int64)[:, None] * page_size + torch.arange(span, device=rows.device)
    w = rows[:, torch.arange(b, device=rows.device)[:, None], at.clamp(max=s - 1)]
    inside = (at < s).reshape(1, b, span, *([1] * (rows.dim() - 3)))
    w = torch.where(inside, w, torch.zeros_like(w))
    return w.reshape(w.shape[0], b, n_blocks, page_size, *w.shape[3:])


def verify_block_span(window: int, page_size: int) -> int:
    """Most whole blocks a verify window of ``window`` tokens can touch (a
    window starting at a block's last row spills ceil((window-1)/page) more
    blocks)."""
    return 1 + (window + page_size - 2) // page_size
