"""Core transformer layers: norms, RoPE, GQA and MLA attention, MLP,
embedding.

Pure functions over parameter dictionaries, as in the JAX package: each
module exposes ``*_defs(cfg) -> ParamDef tree`` and ``*_apply(params, ...)``.
Attention has four execution paths:

  naive   — full (S×S) score matrix; fine for short sequences
  chunked — a loop over KV blocks with online softmax (the "flash" dataflow
            in tensor ops), bounded memory for long prefill
  decode  — one query per sequence against a KV cache
  chunk   — T queries per sequence against a KV cache (chunked prefill and
            speculative verify)

Naive, chunked and chunk are plain tensor ops here, as they are plain jnp
in the JAX package: the flash-attention kernel (``kernels/flash_attention``)
is a public op of its own and no path of the model calls it.  Decode on one
device goes through ``kernels/decode_attention``: on the card a kernel that
reads each live K/V row once for all query heads of its KV head and no row
past the position, on the CPU its plain version, the tensor ops of the JAX
package's function.

Differences from the JAX package, all of them without effect on the numbers:

* ``constrain`` (sharding annotations) is not called: on a mesh each rank
  computes on its own shard, and the shapes of the leaves it is given say
  which (below).
* Decode and chunk take one position per sequence, ``pos`` of shape (B,),
  where the JAX package takes a scalar and maps the whole step over the
  slots of a pool; RoPE, the cache write and the validity mask read each
  row's own position (query ``i`` of row ``b`` sits at ``pos[b] + i``).
* The cache write is in place (``cache_update`` "dus" and "onehot" are the
  same write on one device), where JAX returns a new cache.

Tensor parallelism.  Under an active mesh (``sharding.rules.activate_mesh``)
a rank may be given its "model" block of a leaf (the train step's compute
layout, ``training.train_loop.MeshLayout``), and the layers compute on it:
GQA on the rank's heads (wq and the biases column-parallel, wo
row-parallel), k and v on the heads its q heads read when "kv_heads" does
not divide "model" and wk and wv stay whole, whisper's cross-attention the
same over the encoder's K/V; MLA's prefill form on the rank's heads (wq_b,
wk_b, wv_b column-parallel, the shared k_rope expanded to the local heads,
wo row-parallel; wq_a, wkv_a and the norms whole, so their gradient on a
rank covers its heads alone and the step's all-reduce over "model" sums
it); the MLP on the rank's columns
(wg, wu, wi, bi column-parallel, wd and wo row-parallel, bo added once after
the sum); the embedding on the rank's vocabulary rows (a masked lookup) and
the logits on its vocabulary columns (``model.lm_loss`` reduces the
log-sum-exp over the ranks).  A row-parallel product is followed by the
sum over "model" (``tp_sum``, reduce-from-TP-region;
``core.collectives`` says how it differentiates).  Which leaves are split
is read from their shapes against the config's (``tp_split``), so one
device, a whole leaf and a (1, 1) mesh run the code they ran before.

MLA attention (DeepSeek-V3) has a prefill form that decompresses K/V per
head and runs ``run_attention`` (q/k of width nope + rope, v of its own
width), and decode and chunk forms that attend over the compressed
(c, k_rope) cache with ``q_nope`` absorbed through ``wk_b``, one position
per row as for GQA.  The chunk forms serve one device: whole leaves.

Decode on a mesh (flash-decoding).  The decode forms also take the rank's
block of a cache split over "model" on its sequence axis ("kv_seq", the
dry run's decode cells), read from the cache's length against the cache's
capacity (``capacity``; ``None``: the cache is whole) as ``tp_split`` reads a
leaf: the step's q, k and v are gathered over "model" to every head (a few
KB a row), the new row is written by the rank whose slice holds ``pos``
(``write_cache``'s masked write), each rank attends over its slice with the
global positions, and only the softmax's max, its sum and the P·V partial
are reduced over "model" (``_attend``); the rank's heads of the result go
through wo and ``tp_sum``.  MLA's absorbed form gathers its absorbed
``q_abs`` and ``q_rope`` the same way.  Whole leaves and a whole cache run
the one-device code.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as C
from repro_torch.core import tracing
from repro_torch.kernels.decode_attention import decode_attention, plain_scores
from repro_torch.models.params import ParamDef
from repro_torch.models.quant import QuantTensor, qeinsum
from repro_torch.sharding.rules import MODEL, active_mesh

NEG_INF = -1e30


def _where_valid(mask: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def _sqrt(d: int) -> float:
    """``jnp.sqrt`` of an int: the f32 square root."""
    return float(torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))


# ---------------------------------------------------------------------------
# Tensor parallelism over "model"
# ---------------------------------------------------------------------------
def _dim(w, i: int) -> int:
    return (w.q if isinstance(w, QuantTensor) else w).shape[i]


def tp_split(local: int, whole: int):
    """``None`` when a leaf's dim holds all ``whole`` entries; else (mesh,
    this rank's index on "model") for a rank holding the ``local`` entries
    of its block, one block each of the active mesh's "model" ranks."""
    if local == whole:
        return None
    mesh = active_mesh()
    n = C.axis_size(mesh, MODEL) if mesh is not None else 0
    if n * local != whole:
        raise ValueError(f"a rank holds {local} of {whole} entries; the active mesh's "
                         f"{MODEL!r} axis has {n} ranks")
    return mesh, C.axis_index(mesh, MODEL)


def tp_sum(y: torch.Tensor, split) -> torch.Tensor:
    """Reduce-from-TP-region: the sum over "model" of the ranks' partial
    ``y`` when ``split`` (``tp_split``'s) is a split, else ``y``."""
    return y if split is None else C.all_reduce(y, split[0], MODEL)


def tp_gather(t: torch.Tensor, split, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``t`` along ``dim`` gathered over "model" when
    ``split`` (``tp_split``'s) is a split, else ``t``."""
    return t if split is None else C.all_gather(t, split[0], MODEL, dim=dim)


def own_block(t: torch.Tensor, split, n: int, dim: int) -> torch.Tensor:
    """The rank's ``n`` entries of ``t``'s ``dim`` when ``split`` is a
    split, else ``t``."""
    return t if split is None else t.narrow(dim, split[1] * n, n)


def seq_split(cache: torch.Tensor, capacity: int | None):
    """``tp_split`` of a layer's decode cache over its sequence axis (axis
    1): ``capacity`` positions in all (``None``: the cache's own length)."""
    return tp_split(cache.shape[1], cache.shape[1] if capacity is None else capacity)


def _whole_kv_heads(cache: torch.Tensor, cfg: ArchConfig) -> None:
    if cache.shape[2] != cfg.num_kv_heads:
        raise ValueError(f"a decode cache holding {cache.shape[2]} of {cfg.num_kv_heads} KV "
                         f"heads: the decode body takes whole heads")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_defs(dim: int) -> dict:
    return {"scale": ParamDef((dim,), (None,), init="ones", dtype=torch.float32)}


def rmsnorm(params, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


def layernorm_defs(dim: int) -> dict:
    return {
        "scale": ParamDef((dim,), (None,), init="ones", dtype=torch.float32),
        "bias": ParamDef((dim,), (None,), init="zeros", dtype=torch.float32),
    }


def layernorm(params, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    # torch.full, not torch.tensor: no host-to-device copy, so a CUDA graph
    # can capture it
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotate-half RoPE; positions: (..., S) integers."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # (d/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core: naive / chunked online-softmax / decode
# ---------------------------------------------------------------------------
def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, D) → (B, S, KV·groups, D) for GQA score einsums."""
    if groups == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, d).reshape(b, s, kv * groups, d)


def attention_naive(q, k, v, *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,KV,D). Full score matrix."""
    _, sq, h, d = q.shape
    kv = k.shape[2]
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) / _sqrt(d)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        scores = _where_valid((qpos[:, None] >= kpos[None, :])[None, None], scores)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attention_chunked(q, k, v, *, causal: bool, chunk: int = 1024) -> torch.Tensor:
    """Online softmax over KV chunks: the flash-attention dataflow in tensor
    ops.  Memory O(Sq·chunk) instead of O(Sq·Sk)."""
    b, sq, h, d = q.shape
    dv = v.shape[-1]
    sk, kvh = k.shape[1], k.shape[2]
    if sk % chunk != 0:
        return attention_naive(q, k, v, causal=causal)
    g = h // kvh
    qf = q.to(torch.float32)
    scale = 1.0 / _sqrt(d)
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for idx in range(sk // chunk):
        kb = _repeat_kv(k[:, idx * chunk:(idx + 1) * chunk], g)
        vb = _repeat_kv(v[:, idx * chunk:(idx + 1) * chunk], g)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(torch.float32)) * scale
        if causal:
            kpos = idx * chunk + torch.arange(chunk, device=q.device)
            s = _where_valid((qpos[:, None] >= kpos[None, :])[None, None], s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-37)
    return out.transpose(1, 2).to(q.dtype)  # (B,Sq,H,D)


def _attend(s: torch.Tensor, v: torch.Tensor, eq: str, split) -> torch.Tensor:
    """softmax(s) over its last axis (the cache's positions), contracted with
    ``v`` by ``eq`` into (B, T, H, ...).  On the rank's slice of a cache
    split over "model" (``split``), flash-decoding: the max over every rank
    first, so that a slice of masked rows adds 0; then the sum of the
    exponentials and the P·V partial, each summed over "model"."""
    if split is None:
        return torch.einsum(eq, torch.softmax(s, dim=-1), v)
    mesh = split[0]
    p = torch.exp(s - C.all_reduce_max(s.amax(dim=-1, keepdim=True), mesh, MODEL))
    total = C.all_reduce(p.sum(dim=-1, keepdim=True), mesh, MODEL)  # (B, H, T, 1)
    out = C.all_reduce(torch.einsum(eq, p, v), mesh, MODEL)
    return out / torch.clamp_min(total.transpose(1, 2), 1e-37)


def attention_decode(q, k_cache, v_cache, pos, split=None) -> torch.Tensor:
    """q: (B,1,H,D); caches: (B,Smax,KV,D); pos: (B,) index of each row's
    new token.  Row b attends over cache[b, 0..pos[b]] inclusive (the cache
    is already written at pos): ``kernels/decode_attention.decode_attention``.
    With ``split`` (``seq_split``'s) the caches are the rank's slice of the
    positions and q holds every head: the plain version's scores
    (``plain_scores``), their softmax over the ranks (``_attend``).  ``pos``
    None comes only with a split: whisper's cross-attention over the rank's
    slice of the frames, every row (on one device it is
    ``gqa_cross_apply``).

    A call over the positions counts ``attn.decode_calls`` and
    ``attn.rows_scored``, the B x Sk cache rows its mask spans, live or not
    (``core/tracing.py``); the kernel reads only the live ones."""
    if pos is not None:
        tracing.count("attn.decode_calls")
        tracing.count("attn.rows_scored", q.shape[0] * k_cache.shape[1])
    if split is None:
        return decode_attention(q, k_cache, v_cache, pos)
    valid = None
    if pos is not None:  # the rank's slice of the positions
        kpos = torch.arange(k_cache.shape[1], device=q.device) + split[1] * k_cache.shape[1]
        valid = kpos[None, :] <= pos[:, None]
    s, v = plain_scores(q, k_cache, v_cache, valid)
    return _attend(s, v, "bhqk,bkhd->bqhd", split).to(q.dtype)


def attention_chunk(q, k_cache, v_cache, pos) -> torch.Tensor:
    """q: (B,T,H,D) queries at positions pos[b]..pos[b]+T-1; caches:
    (B,Smax,KV,D) already written through pos[b]+T-1; pos: (B,).

    Query ``i`` of row ``b`` attends over cache[b, 0..pos[b]+i]; rows past it
    are dead data and masked out.  The strict positional mask is also what
    makes speculative verify rollback-free for attention caches: rows written
    for rejected candidates sit past the committed prefix, so the next
    window's queries never see them and its writes overwrite them."""
    _, t, h, d = q.shape
    g = h // k_cache.shape[2]
    qf = q.to(torch.float32)
    k = _repeat_kv(k_cache, g)
    v = _repeat_kv(v_cache, g)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.to(torch.float32)) / _sqrt(d)
    qpos = pos[:, None] + torch.arange(t, device=q.device)  # (B, T)
    valid = torch.arange(k_cache.shape[1], device=q.device)[None, None, :] <= qpos[:, :, None]
    s = _where_valid(valid[:, None], s)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def run_attention(cfg: ArchConfig, q, k, v, *, causal: bool) -> torch.Tensor:
    impl = cfg.attention_impl
    if impl == "auto":
        impl = "chunked" if q.shape[1] > 2 * cfg.attn_chunk else "naive"
    if impl == "chunked":
        return attention_chunked(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    if impl != "naive":
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    return attention_naive(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------
def gqa_defs(cfg: ArchConfig, *, cross: bool = False) -> dict:
    """The GQA projections (and QKV biases).  ``cross`` (whisper's decoder
    cross-attention) takes the same leaves, as in the JAX package: its wk/wv
    project the encoder output."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((kv, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = ParamDef((kv, hd), ("kv_heads", None), init="zeros")
    return defs


def _local_kv(q, k, v, cfg: ArchConfig):
    """k and v for the rank's q heads.  Split over "model" with q, or whole
    with q, they are as they are; whole while q is split (kv_heads does not
    divide "model"), each local q head takes its own KV head (global q head
    j reads KV head j // (heads / kv_heads)), one a q head."""
    h_loc = q.shape[2]
    if k.shape[2] != cfg.num_kv_heads or h_loc == cfg.num_heads:
        return k, v
    _, r = tp_split(h_loc, cfg.num_heads)
    group = cfg.num_heads // cfg.num_kv_heads
    idx = (r * h_loc + torch.arange(h_loc, device=k.device)) // group
    return k[:, :, idx], v[:, :, idx]


def _qkv(params, x, cfg: ArchConfig):
    q = qeinsum("bsd,dhe->bshe", x, params["wq"])
    k = qeinsum("bsd,dhe->bshe", x, params["wk"])
    v = qeinsum("bsd,dhe->bshe", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def gqa_project_qkv(params, x, cfg: ArchConfig, positions, *, rope: bool = True):
    q, k, v = _qkv(params, x, cfg)
    k, v = _local_kv(q, k, v, cfg)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_out(params, out, cfg: ArchConfig):
    """The attention output (B, S, H, hd) through wo, summed over "model"
    when the rank holds its block of the heads."""
    y = qeinsum("bshe,hed->bsd", out, params["wo"])
    return tp_sum(y, tp_split(_dim(params["wo"], 0), cfg.num_heads))


def gqa_apply(params, x, cfg: ArchConfig, *, causal: bool = True, rope: bool = True):
    """Full-sequence GQA attention (train / prefill path)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = gqa_project_qkv(params, x, cfg, positions, rope=rope)
    out = run_attention(cfg, q, k, v, causal=causal)
    return gqa_out(params, out, cfg)


def gqa_cross_apply(params, x, kv_pair, cfg: ArchConfig):
    """Cross-attention (whisper's decoder): queries from ``x`` (B, T, D)
    through wq (+ bq), attending without a mask over ``kv_pair`` = (k, v),
    (B, Sk, KV, hd) precomputed from the encoder output (on the rank's KV
    heads when wk and wv are split; ``_local_kv`` when they are whole and wq
    is not); then wo, as ``gqa_out``."""
    q = qeinsum("bsd,dhe->bshe", x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    k, v = _local_kv(q, *kv_pair, cfg)
    out = run_attention(cfg, q, k, v, causal=False)
    # on the rank's heads the sum over "model" after wo (ROADMAP Queue A item 17)
    return gqa_out(params, out, cfg)


def write_cache(cache, new, pos, cfg: ArchConfig, split=None):
    """Write one row per sequence, ``new[b, 0]`` at ``cache[b, pos[b]]``
    (the sequence axis is 1), in place, and return the cache.  With
    ``split`` (``seq_split``'s) the cache is the rank's slice of the
    positions: a row whose ``pos`` lies outside it writes back what its
    slice's first position holds (an index that never leaves the slice)."""
    if cfg.cache_update not in ("dus", "onehot"):
        raise ValueError(f"unknown cache_update {cfg.cache_update!r}")
    rows = torch.arange(cache.shape[0], device=cache.device)
    new = new[:, 0].to(cache.dtype)
    if split is None:
        cache[rows, pos] = new
        return cache
    local = pos - split[1] * cache.shape[1]
    held = (local >= 0) & (local < cache.shape[1])
    at = torch.where(held, local, torch.zeros_like(local))
    held = held.reshape(-1, *(1,) * (new.dim() - 1))
    cache[rows, at] = torch.where(held, new, cache[rows, at])
    return cache


def write_cache_span(cache, new, pos):
    """Write ``new[b, i]`` at ``cache[b, start[b] + i]`` (the sequence axis is
    1), in place, and return the cache.  ``start`` is ``pos`` clamped to
    [0, Smax - T], as ``dynamic_update_slice`` clamps in the JAX package."""
    b, t = new.shape[:2]
    start = torch.clamp(pos, 0, cache.shape[1] - t)
    rows = start[:, None] + torch.arange(t, device=cache.device)
    cache[torch.arange(b, device=cache.device)[:, None], rows] = new.to(cache.dtype)
    return cache


def gqa_chunk_apply(params, x, cache_k, cache_v, pos, cfg: ArchConfig, *, rope: bool = True):
    """Chunked-prefill attention: T tokens a row appended at ``pos`` (B,).
    x: (B,T,D).  Returns (out, k_cache, v_cache), the chunk's K/V written in
    place into the span [pos[b], pos[b]+T)."""
    positions = pos[:, None] + torch.arange(x.shape[1], device=x.device)
    q, k_new, v_new = gqa_project_qkv(params, x, cfg, positions, rope=rope)
    k_cache = write_cache_span(cache_k, k_new, pos)
    v_cache = write_cache_span(cache_v, v_new, pos)
    out = attention_chunk(q, k_cache, v_cache, pos)
    return qeinsum("bshe,hed->bsd", out, params["wo"]), k_cache, v_cache


def _decode_qkv(params, x, cfg: ArchConfig, positions, *, rope: bool):
    """The step's q, k and v on every head: a projection the rank holds its
    block of heads of (``tp_split`` of wq's, wk's, wv's heads) gathered
    over "model" after its bias and RoPE."""
    q, k, v = _qkv(params, x, cfg)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    wholes = (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads)
    return tuple(tp_gather(t, tp_split(_dim(params[w], 1), n), 2)
                 for t, w, n in zip((q, k, v), ("wq", "wk", "wv"), wholes))


def _heads_out(params, out, cfg: ArchConfig):
    """The attention output on every head (B, T, H, hd) through wo: the
    rank's heads where wo holds its block of them, then ``gqa_out``."""
    h = _dim(params["wo"], 0)
    return gqa_out(params, own_block(out, tp_split(h, cfg.num_heads), h, 2), cfg)


def gqa_decode_apply(params, x, cache_k, cache_v, pos, cfg: ArchConfig, *, rope: bool = True,
                     capacity: int | None = None):
    """One-token decode.  x: (B,1,D); pos: (B,).  Returns (out, k_cache,
    v_cache), the caches written in place.  On a mesh the caches may be the
    rank's slice of ``capacity`` positions, with every KV head
    (flash-decoding, the module docstring)."""
    _whole_kv_heads(cache_k, cfg)
    split = seq_split(cache_k, capacity)
    q, k_new, v_new = _decode_qkv(params, x, cfg, pos[:, None], rope=rope)
    k_cache = write_cache(cache_k, k_new, pos, cfg, split)
    v_cache = write_cache(cache_v, v_new, pos, cfg, split)
    out = attention_decode(q, k_cache, v_cache, pos, split)
    return _heads_out(params, out, cfg), k_cache, v_cache


def gqa_cross_decode(params, x, cache_k, cache_v, cfg: ArchConfig):
    """Whisper's cross-attention of one token a row against the static
    encoder K/V (B, encoder_seq, KV, hd): ``gqa_cross_apply`` where the K/V
    are whole; on the rank's slice of the frames, q on every head attends
    over it with the split softmax and no mask (``attention_decode``)."""
    split = tp_split(cache_k.shape[1], cfg.encoder_seq)
    if split is None:
        return gqa_cross_apply(params, x, (cache_k, cache_v), cfg)
    _whole_kv_heads(cache_k, cfg)
    q = qeinsum("bsd,dhe->bshe", x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    q = tp_gather(q, tp_split(_dim(params["wq"], 1), cfg.num_heads), 2)
    return _heads_out(params, attention_decode(q, cache_k, cache_v, None, split), cfg)


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V3): compressed-KV attention
# ---------------------------------------------------------------------------
def mla_defs(cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ParamDef((d, m.q_lora_rank), ("embed", None)),
        "q_norm": rmsnorm_defs(m.q_lora_rank),
        "wq_b": ParamDef((m.q_lora_rank, h, qd), (None, "heads", None)),
        "wkv_a": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", None)),
        "kv_norm": rmsnorm_defs(m.kv_lora_rank),
        "wk_b": ParamDef((m.kv_lora_rank, h, m.qk_nope_head_dim), (None, "heads", None)),
        "wv_b": ParamDef((m.kv_lora_rank, h, m.v_head_dim), (None, "heads", None)),
        "wo": ParamDef((h, m.v_head_dim, d), ("heads", None, "embed")),
    }


def _mla_q(params, x, cfg, positions):
    m = cfg.mla
    cq = qeinsum("bsd,dr->bsr", x, params["wq_a"])
    cq = rmsnorm(params["q_norm"], cq, cfg.norm_eps)
    q = qeinsum("bsr,rhe->bshe", cq, params["wq_b"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_ckv(params, x, cfg, positions):
    m = cfg.mla
    ckv = qeinsum("bsd,dr->bsr", x, params["wkv_a"])
    c, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c = rmsnorm(params["kv_norm"], c, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c, k_rope  # (B,S,r), (B,S,rope_d)


def _mla_heads(params) -> int:
    """The heads a rank computes MLA on: wq_b's, wk_b's, wv_b's and wo's,
    which the rules split together (a rank holding some of them split and
    others whole has no body)."""
    held = {_dim(params["wq_b"], 1), _dim(params["wk_b"], 1), _dim(params["wv_b"], 1),
            _dim(params["wo"], 0)}
    if len(held) != 1:
        raise ValueError(f"wq_b, wk_b, wv_b and wo hold {sorted(held)} heads: one count expected")
    return held.pop()


def mla_prefill_attn(params, x, cfg: ArchConfig, *, causal: bool = True):
    """Train/prefill MLA: decompress K/V per head, then standard attention
    (q/k of width nope + rope against v of width ``v_head_dim``).  Returns
    (out, (c, k_rope)), the compressed cache rows for a prefill.  On the
    rank's block of the heads (wq_b, wk_b, wv_b split, wo row-parallel) the
    shared k_rope is expanded to those heads and wo's product is summed over
    "model"; wq_a, wkv_a and the two norms are whole."""
    m = cfg.mla
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    c, k_rope = _mla_ckv(params, x, cfg, positions)
    k_nope = qeinsum("bsr,rhe->bshe", c, params["wk_b"])
    v = qeinsum("bsr,rhe->bshe", c, params["wv_b"])
    h = _mla_heads(params)
    k_rope_h = k_rope[:, :, None, :].expand(*k_rope.shape[:2], h, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    out = run_attention(cfg, q, k, v, causal=causal)  # kv heads == q heads (decompressed)
    y = qeinsum("bshe,hed->bsd", out, params["wo"])
    return tp_sum(y, tp_split(h, cfg.num_heads)), (c, k_rope)


def mla_apply(params, x, cfg: ArchConfig, *, causal: bool = True):
    """Train/prefill MLA (see :func:`mla_prefill_attn`)."""
    return mla_prefill_attn(params, x, cfg, causal=causal)[0]


def _mla_absorbed(params, q_nope, q_rope, cache_c, cache_krope, valid, cfg, dtype, split=None):
    """Attention over the compressed cache: q_nope absorbed through wk_b
    into the latent space, the scores ``(q_abs·c + q_rope·k_rope) /
    sqrt(nope + rope)`` in f32 with the cache upcast, ``valid`` (B, T, S)
    masking the dead rows, the output back through wv_b and wo.  On the
    rank's heads ``q_abs`` and ``q_rope`` are gathered over "model" to
    every head, and the rank's heads of ``o_c`` go through wv_b and wo,
    then ``tp_sum``; with ``split`` the caches are the rank's slice of the
    positions (``_attend``)."""
    m = cfg.mla
    h = _mla_heads(params)
    heads = tp_split(h, cfg.num_heads)
    q_abs = tp_gather(qeinsum("bqhe,rhe->bqhr", q_nope, params["wk_b"]), heads, 2)  # (B,T,H,r)
    q_rope = tp_gather(q_rope, heads, 2)
    s = torch.einsum("bqhr,bkr->bhqk", q_abs.to(torch.float32), cache_c.to(torch.float32))
    s = s + torch.einsum("bqhe,bke->bhqk", q_rope.to(torch.float32),
                         cache_krope.to(torch.float32))
    s = s / _sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = _where_valid(valid[:, None], s)
    o_c = _attend(s, cache_c.to(torch.float32), "bhqk,bkr->bqhr", split).to(dtype)
    out = qeinsum("bqhr,rhe->bqhe", own_block(o_c, heads, h, 2), params["wv_b"])
    return tp_sum(qeinsum("bshe,hed->bsd", out, params["wo"]), heads)


def mla_decode_apply(params, x, cache_c, cache_krope, pos, cfg: ArchConfig, *,
                     capacity: int | None = None):
    """Absorbed-MLA decode: one token a row at ``pos`` (B,), attending
    directly over the compressed cache, O(S·r) a step instead of O(S·h·d).
    Returns (out, cache_c, cache_krope), the caches written in place.  On a
    mesh the caches may be the rank's slice of ``capacity`` positions
    (flash-decoding, the module docstring)."""
    split = seq_split(cache_c, capacity)
    positions = pos[:, None]
    q_nope, q_rope = _mla_q(params, x, cfg, positions)  # (B,1,H,*)
    c_new, krope_new = _mla_ckv(params, x, cfg, positions)  # (B,1,r), (B,1,rd)
    cache_c = write_cache(cache_c, c_new, pos, cfg, split)
    cache_krope = write_cache(cache_krope, krope_new, pos, cfg, split)
    kpos = torch.arange(cache_c.shape[1], device=x.device)
    if split is not None:
        kpos = kpos + split[1] * cache_c.shape[1]
    valid = kpos[None, None, :] <= pos[:, None, None]
    out = _mla_absorbed(params, q_nope, q_rope, cache_c, cache_krope, valid, cfg, x.dtype, split)
    return out, cache_c, cache_krope


def mla_chunk_apply(params, x, cache_c, cache_krope, pos, cfg: ArchConfig):
    """Absorbed-MLA chunk: ``mla_decode_apply`` generalized to T queries a
    row at positions [pos[b], pos[b]+T).  The chunk's compressed rows are
    written in place and every query attends causally over the compressed
    cache, the decode step's numerical path."""
    t = x.shape[1]
    positions = pos[:, None] + torch.arange(t, device=x.device)  # (B, T)
    q_nope, q_rope = _mla_q(params, x, cfg, positions)  # (B,T,H,*)
    c_new, krope_new = _mla_ckv(params, x, cfg, positions)  # (B,T,r), (B,T,rd)
    cache_c = write_cache_span(cache_c, c_new, pos)
    cache_krope = write_cache_span(cache_krope, krope_new, pos)
    valid = torch.arange(cache_c.shape[1], device=x.device)[None, None, :] <= positions[:, :, None]
    out = _mla_absorbed(params, q_nope, q_rope, cache_c, cache_krope, valid, cfg, x.dtype)
    return out, cache_c, cache_krope


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU) with activation-variant axis
# ---------------------------------------------------------------------------
def mlp_defs(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation == "gelu":  # classic 2-matrix MLP
        return {
            "wi": ParamDef((d, f), ("embed", "mlp")),
            "bi": ParamDef((f,), ("mlp",), init="zeros"),
            "wo": ParamDef((f, d), ("mlp", "embed")),
            "bo": ParamDef((d,), (None,), init="zeros"),
        }
    return {  # SwiGLU
        "wg": ParamDef((d, f), ("embed", "mlp")),
        "wu": ParamDef((d, f), ("embed", "mlp")),
        "wd": ParamDef((f, d), ("mlp", "embed")),
    }


def mlp_apply(params, x, cfg: ArchConfig):
    """The MLP; on the rank's block of its ``d_ff`` columns, the sum over
    "model" of the down projection, then ``bo``."""
    from repro_torch.models.activations import get_activation

    act = get_activation(cfg.activation, cfg.activation_impl)
    if "wi" in params:
        h = qeinsum("bsd,df->bsf", x, params["wi"]) + params["bi"].to(x.dtype)
        y = qeinsum("bsf,fd->bsd", act(h), params["wo"])
        split = tp_split(_dim(params["wo"], 0), cfg.d_ff)
        return tp_sum(y, split) + params["bo"].to(x.dtype)
    g = qeinsum("bsd,df->bsf", x, params["wg"])
    u = qeinsum("bsd,df->bsf", x, params["wu"])
    y = qeinsum("bsf,fd->bsd", act(g) * u, params["wd"])
    return tp_sum(y, tp_split(_dim(params["wd"], 0), cfg.d_ff))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_defs(cfg: ArchConfig) -> dict:
    v = cfg.padded_vocab
    defs = {"tokens": ParamDef((v, cfg.d_model), ("vocab", "embed"), init="normal")}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, v), ("embed", "vocab"))
    return defs


def embed_apply(params, tokens, cfg: ArchConfig):
    """The tokens' rows; on the rank's block of the vocabulary, the rows it
    holds (zeros for the others) summed over "model"."""
    table = params["tokens"]
    split = tp_split(table.shape[0], cfg.padded_vocab)
    if split is None:
        return table[tokens]
    local = tokens - split[1] * table.shape[0]
    held = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(held, local, torch.zeros_like(local))]
    return tp_sum(torch.where(held[..., None], rows, torch.zeros_like(rows)), split)


def vocab_split(params, cfg: ArchConfig):
    """``tp_split`` of the logits' vocabulary columns (the unembedding's, or
    the tied embedding's rows)."""
    w = params.get("unembed")
    return tp_split(params["tokens"].shape[0] if w is None else w.shape[1], cfg.padded_vocab)


def unembed_apply(params, x, cfg: ArchConfig):
    """Not quantized, as in the JAX package: a plain product.  On the rank's
    block of the vocabulary, its columns of the logits (``vocab_split``)."""
    w = params.get("unembed")
    if w is None:
        w = params["tokens"].T
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum("bsd,dv->bsv", x.to(dt), w.to(dt))
