"""Decoder-only language models with GQA attention: the dense SwiGLU stack
(granite-3.0-8b) and the top-k MoE stack (granite-3.0-3b-a800m).

Everything of this model family lives here, and none of it imports the program:

* ``make_weights``: the configuration's weights, drawn from ``--seed`` on
  the card by a ``torch.Generator`` (one draw a leaf, stacked over the
  layers) and stored in the types they are served in: every projection
  int8 per output column (``quantizer.quantize_weight``, a layer at a
  time), the embedding and the LM head bf16, the norms and the router f32.
* ``reference_logits``: the plain forward pass in float32 (TF32 off) over
  one whole sequence, no cache and no batching, from the same weights.  It
  computes what the configuration states: each projection's input
  quantized per row to int8 (the frozen quantizer) and contracted with the
  dequantized int8 weight; attention, norms, RoPE, the router, the
  softmax and the LM head in f32.  Attention runs in blocks of queries so
  that 16k-token sequences fit.
* the counts of the served work (``k5_calls``, ``work_ops``,
  ``work_bytes``, ``work_k5_calls``): the yardstick of ``model_mfu``,
  ``model_hbm_share`` and ``int8_matmul_roofline``, from the sizes alone.
* the map onto the port (``arch_overrides``, ``check_arch``,
  ``rehearsal_config``, ``program_tree``): the cut of its registered
  architecture, the widths it must have, and its parameter tree over these
  weights, built with the quantized type the caller hands in.

A model module of another family brings the same functions; the harness
reaches them through the configuration file's ``model`` key.

The math is the one the port serves (llama-style blocks: RMSNorm, rotate-half
RoPE, GQA, SwiGLU; granite-moe's router softmax over the real experts,
top-k renormalised, each expert a SwiGLU).  Granite's published
``embedding_multiplier``, ``attention_multiplier``, ``residual_multiplier``
and ``logits_scaling`` are not applied by the port, and so not here either;
the configuration files list them under ``departures``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from perfbench.quantizer import dequantize, fake_quant_rows, quantize_weight

ATTN_BLOCK = 1024  # queries a block in the reference's attention
KV_BYTES = 2  # bf16 cache entries


@dataclasses.dataclass(frozen=True)
class Sizes:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    vocab_rows: int         # the embedding's rows as the port lays them out
    eps: float
    theta: float
    experts: int = 0        # routed experts (0: a dense MLP)
    experts_held: int = 0   # expert weights held, padding included
    top_k: int = 0

    @property
    def moe(self) -> bool:
        return self.experts > 0


def sizes(cfg: dict) -> Sizes:
    """The sizes of a configuration file (its published keys, as cut)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    experts = cfg.get("num_local_experts", 0)
    assumed = cfg.get("assumed", {})
    return Sizes(layers=cfg["num_hidden_layers"], d=d, heads=h,
                 kv_heads=cfg["num_key_value_heads"], head_dim=cfg.get("head_dim") or d // h,
                 ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                 vocab_rows=assumed.get("embedding_rows", cfg["vocab_size"]),
                 eps=cfg["rms_norm_eps"], theta=cfg["rope_theta"], experts=experts,
                 experts_held=assumed.get("padded_experts", experts),
                 top_k=cfg.get("num_experts_per_tok", 0))


# (name, stacked shape without the layer axis, lead axes after the layer
# axis, contraction axes) of each int8 projection
def projections(s: Sizes) -> list[tuple[str, tuple[int, ...], int, int]]:
    out = [("wq", (s.d, s.heads, s.head_dim), 0, 1),
           ("wk", (s.d, s.kv_heads, s.head_dim), 0, 1),
           ("wv", (s.d, s.kv_heads, s.head_dim), 0, 1),
           ("wo", (s.heads, s.head_dim, s.d), 0, 2)]
    if s.moe:
        e = s.experts_held
        return out + [("wg", (e, s.d, s.ff), 1, 1), ("wu", (e, s.d, s.ff), 1, 1),
                      ("wd", (e, s.ff, s.d), 1, 1)]
    return out + [("wg", (s.d, s.ff), 0, 1), ("wu", (s.d, s.ff), 0, 1), ("wd", (s.ff, s.d), 0, 1)]


def make_weights(cfg: dict, seed: int, device, *, levels: int = 127) -> dict:
    """The weights of ``cfg`` from ``seed``: {name: tensor} for the
    embedding ("embed", (vocab_rows, d) bf16), the LM head ("unembed", (d,
    vocab_rows) bf16), the norms ("ln1", "ln2": (L, d), "final_norm": (d,)
    f32), granite-moe's router ("router", (L, d, experts_held) f32), and
    each projection as (q int8 (L, ...), scale f32) under its name.  The
    draws do not depend on ``levels`` (127: int8; 7: the control's int4)."""
    s = sizes(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2**63))

    def normal(shape, std, dtype=torch.bfloat16):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return w.mul_(std)

    w: dict = {"embed": normal((s.vocab_rows, s.d), 0.02),
               "unembed": normal((s.d, s.vocab_rows), 1 / math.sqrt(s.d)),
               "final_norm": 1 + normal((s.d,), 0.1, torch.float32),
               "ln1": 1 + normal((s.layers, s.d), 0.1, torch.float32),
               "ln2": 1 + normal((s.layers, s.d), 0.1, torch.float32)}
    if s.moe:
        w["router"] = normal((s.layers, s.d, s.experts_held), 1 / math.sqrt(s.d), torch.float32)
    for name, shape, lead, contract in projections(s):
        fan_in = math.prod(shape[lead:lead + contract])
        full = normal((s.layers, *shape), 1 / math.sqrt(fan_in))
        pairs = [quantize_weight(full[i], lead, contract, levels) for i in range(s.layers)]
        del full
        w[name] = (torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs]))
    return w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over (S, H, D) at positions 0..S-1."""
    s, d = x.shape[0], x.shape[-1]
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                            torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _proj(x: torch.Tensor, w: torch.Tensor, act_levels: int) -> torch.Tensor:
    """x (..., K) quantized per row, times the dequantized (K, N) weight."""
    return fake_quant_rows(x, act_levels) @ w


def _attention(q, k, v) -> torch.Tensor:
    """Causal GQA over (S, H, D) queries and (S, KV, D) keys and values."""
    s, h, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).permute(1, 2, 0)   # (H, D, S)
    v = v.repeat_interleave(g, dim=1).permute(1, 0, 2)   # (H, S, D)
    out = torch.empty_like(q)
    kpos = torch.arange(s, device=q.device)
    for a in range(0, s, ATTN_BLOCK):
        b = min(s, a + ATTN_BLOCK)
        sc = torch.matmul(q[a:b].permute(1, 0, 2), k[:, :, :b]) / math.sqrt(d)  # (H, b-a, b)
        mask = kpos[None, :b] <= torch.arange(a, b, device=q.device)[:, None]
        sc = torch.where(mask[None], sc, torch.full_like(sc, float("-inf")))
        out[a:b] = torch.matmul(torch.softmax(sc, dim=-1), v[:, :b]).permute(1, 0, 2)
    return out


def _layer_weight(w: dict, name: str, layer: int, s: Sizes) -> torch.Tensor:
    q, scale = w[name]
    lead, contract = next((l, c) for n, _, l, c in projections(s) if n == name)
    return dequantize(q[layer], scale[layer], lead, contract)


def _swiglu(x, wg, wu, wd, act_levels):
    g = _proj(x, wg, act_levels)
    u = _proj(x, wu, act_levels)
    return _proj(torch.nn.functional.silu(g) * u, wd, act_levels)


def _moe(x, w: dict, layer: int, s: Sizes, act_levels: int) -> torch.Tensor:
    """Softmax over the real experts, top-k renormalised, each token's k
    experts' SwiGLU outputs summed by their weights."""
    probs = torch.softmax(x @ w["router"][layer][:, : s.experts], dim=-1)
    top, ids = torch.topk(probs, s.top_k, dim=-1)
    top = top / top.sum(dim=-1, keepdim=True)
    wg, wu, wd = (_layer_weight(w, n, layer, s) for n in ("wg", "wu", "wd"))
    y = torch.zeros_like(x)
    for e in ids.unique().tolist():
        rows, slot = (ids == e).nonzero(as_tuple=True)
        y.index_add_(0, rows, top[rows, slot][:, None] * _swiglu(x[rows], wg[e], wu[e], wd[e],
                                                                 act_levels))
    return y


@torch.inference_mode()
def reference_logits(w: dict, cfg: dict, tokens: torch.Tensor, first: int,
                     *, act_levels: int = 127) -> torch.Tensor:
    """f32 logits over the vocabulary at positions ``first``..S-1 of the
    sequence ``tokens`` (S,): row i predicts ``tokens[first + i + 1]``."""
    s = sizes(cfg)
    x = w["embed"][tokens].to(torch.float32)
    n = tokens.shape[0]
    for layer in range(s.layers):
        h = _rmsnorm(x, w["ln1"][layer], s.eps)
        q = _proj(h, _layer_weight(w, "wq", layer, s).reshape(s.d, -1), act_levels)
        k = _proj(h, _layer_weight(w, "wk", layer, s).reshape(s.d, -1), act_levels)
        v = _proj(h, _layer_weight(w, "wv", layer, s).reshape(s.d, -1), act_levels)
        q = _rope(q.reshape(n, s.heads, s.head_dim), s.theta)
        k = _rope(k.reshape(n, s.kv_heads, s.head_dim), s.theta)
        a = _attention(q, k, v.reshape(n, s.kv_heads, s.head_dim)).reshape(n, -1)
        x = x + _proj(a, _layer_weight(w, "wo", layer, s).reshape(-1, s.d), act_levels)
        h = _rmsnorm(x, w["ln2"][layer], s.eps)
        if s.moe:
            x = x + _moe(h, w, layer, s, act_levels)
        else:
            x = x + _swiglu(h, *(_layer_weight(w, m, layer, s) for m in ("wg", "wu", "wd")),
                            act_levels)
    hidden = _rmsnorm(x[first:], w["final_norm"], s.eps)
    return hidden @ w["unembed"][:, : s.vocab].to(torch.float32)


# ---------------------------------------------------------------------------
# The map onto the port
# ---------------------------------------------------------------------------
def arch_overrides(cfg: dict) -> dict:
    """What the configuration file changes in the port's registered
    architecture: its depth."""
    return {"num_layers": cfg["num_hidden_layers"]}


def check_arch(arch, cfg: dict) -> None:
    """Raise unless the port's architecture has the file's widths."""
    s = sizes(cfg)
    got = (arch.d_model, arch.num_heads, arch.num_kv_heads, arch.resolved_head_dim,
           arch.vocab_size, arch.padded_vocab, arch.norm_eps, arch.rope_theta)
    want = (s.d, s.heads, s.kv_heads, s.head_dim, s.vocab, s.vocab_rows, s.eps, s.theta)
    if arch.moe is not None:
        m = arch.moe
        got += (m.num_experts, m.padded_experts or m.num_experts, m.top_k, m.expert_d_ff)
        want += (s.experts, s.experts_held, s.top_k, s.ff)
    else:
        got += (arch.d_ff,)
        want += (s.ff,)
    if got != want:
        raise ValueError(f"{cfg['name']}: the port's {cfg['program_arch']} has sizes {got}, "
                         f"the configuration file {want}")


def rehearsal_config(cfg: dict, arch) -> dict:
    """The configuration file's keys at the port's reduced sizes (the CPU
    rehearsal): the same plain model, tiny."""
    out = dict(cfg, hidden_size=arch.d_model, num_attention_heads=arch.num_heads,
               num_key_value_heads=arch.num_kv_heads, head_dim=arch.resolved_head_dim,
               vocab_size=arch.vocab_size, num_hidden_layers=arch.num_layers,
               rms_norm_eps=arch.norm_eps, rope_theta=arch.rope_theta)
    assumed = dict(cfg.get("assumed", {}), embedding_rows=arch.padded_vocab)
    if arch.moe is not None:
        out.update(intermediate_size=arch.moe.expert_d_ff, num_local_experts=arch.moe.num_experts,
                   num_experts_per_tok=arch.moe.top_k)
        assumed["padded_experts"] = arch.moe.padded_experts or arch.moe.num_experts
    else:
        out["intermediate_size"] = arch.d_ff
    out["assumed"] = assumed
    return out


def program_tree(w: dict, cfg: dict, quant) -> dict:
    """The port's parameter tree over the weights of ``make_weights``;
    ``quant(q, scale)`` wraps an int8 projection in the port's type."""
    s = sizes(cfg)
    qt = {name: quant(*w[name]) for name, *_ in projections(s)}
    block = {"ln1": {"scale": w["ln1"]}, "ln2": {"scale": w["ln2"]},
             "attn": {k: qt[k] for k in ("wq", "wk", "wv", "wo")}}
    ffn = {k: qt[k] for k in ("wg", "wu", "wd")}
    if s.moe:
        block["moe"] = dict(ffn, router=w["router"])
    else:
        block["mlp"] = ffn
    return {"embed": {"tokens": w["embed"], "unembed": w["unembed"]},
            "final_norm": {"scale": w["final_norm"]}, "blocks": block}


# ---------------------------------------------------------------------------
# Counts of the served work
# ---------------------------------------------------------------------------
# The work events are those the loop records (``loop.Work``): a prefill of S
# prompt tokens, a chunk of t tokens for each of k rows at position p, and a
# decode tick over the live slots' positions.
def k5_calls(s: Sizes, m: int) -> list[tuple[int, int, int, int, bool]]:
    """The ``int8_matmul`` launches of one model call over ``m`` rows, for
    every layer: (m, k, n, batch, x_shared).  Attention's wq, wk, wv, wo,
    then the MLP's wg, wu, wd, or the MoE's three expert products, each
    ONE launch over every expert held (wg and wu share one quantized
    token block)."""
    d, qd, kvd = s.d, s.heads * s.head_dim, s.kv_heads * s.head_dim
    layer = [(m, d, qd, 1, False), (m, d, kvd, 1, False), (m, d, kvd, 1, False),
             (m, qd, d, 1, False)]
    if s.moe:
        e = s.experts_held
        layer += [(m, d, s.ff, e, True), (m, d, s.ff, e, True), (m, s.ff, d, e, False)]
    else:
        layer += [(m, d, s.ff, 1, False), (m, d, s.ff, 1, False), (m, s.ff, d, 1, False)]
    return layer * s.layers


def matmul_params_per_token(s: Sizes) -> int:
    """Weights a token multiplies by in one layer: the projections, and
    the router and its top-k experts (not the padding, not the others)."""
    attn = s.d * s.heads * s.head_dim * 2 + 2 * s.d * s.kv_heads * s.head_dim
    ffn = s.top_k * 3 * s.d * s.ff + s.d * s.experts if s.moe else 3 * s.d * s.ff
    return attn + ffn


def weight_bytes(s: Sizes) -> int:
    """Bytes of the weights a step reads once: int8 projections with their
    f32 column scales (the real experts only), the bf16 LM head over the
    real vocabulary, the f32 norms and router."""
    d, qd, kvd = s.d, s.heads * s.head_dim, s.kv_heads * s.head_dim
    attn = d * qd + 2 * d * kvd + qd * d + 4 * (qd + 2 * kvd + d)
    if s.moe:
        ffn = s.experts * (3 * d * s.ff + 4 * (2 * s.ff + d)) + 4 * d * s.experts
    else:
        ffn = 3 * d * s.ff + 4 * (2 * s.ff + d)
    return s.layers * (attn + ffn + 8 * d) + 2 * d * s.vocab + 4 * d


def kv_row_bytes(s: Sizes) -> int:
    """Cache bytes of one position over every layer (K and V)."""
    return s.layers * 2 * s.kv_heads * s.head_dim * KV_BYTES


def _attn_ops(s: Sizes, contexts: float) -> float:
    return 4.0 * s.heads * s.head_dim * contexts * s.layers


def work_ops(s: Sizes, kind: str, **w) -> float:
    """Operations a work event needs: 2 x matmul params x tokens, attention's
    4 x heads x head_dim x live context a token and layer, and the LM head
    for each token it emits."""
    per_tok = 2.0 * matmul_params_per_token(s) * s.layers
    head = 2.0 * s.d * s.vocab
    if kind == "prefill":
        n = w["tokens"]
        return per_tok * n + _attn_ops(s, n * (n + 1) / 2) + head
    if kind == "chunk":
        k, p, t = w["rows"], w["pos"], w["tokens"]
        return k * (per_tok * t + _attn_ops(s, t * p + t * (t + 1) / 2)) + (head * k if w["last"] else 0)
    if kind == "tick":
        pos = w["positions"]
        return len(pos) * (per_tok + head) + _attn_ops(s, sum(p + 1 for p in pos))
    raise ValueError(kind)


def work_bytes(s: Sizes, kind: str, **w) -> float:
    """HBM bytes a work event needs: the weights once, plus each live
    slot's cache rows up to its position (a tick) or the rows written (a
    prefill or chunk)."""
    if kind == "prefill":
        return weight_bytes(s) + w["tokens"] * kv_row_bytes(s)
    if kind == "chunk":
        return weight_bytes(s) + w["rows"] * w["tokens"] * kv_row_bytes(s)
    if kind == "tick":
        return weight_bytes(s) + sum(p + 1 for p in w["positions"]) * kv_row_bytes(s)
    raise ValueError(kind)


def work_k5_calls(s: Sizes, kind: str, max_batch: int, **w) -> list:
    """The ``int8_matmul`` launches of a work event: a tick runs every slot
    of the pool (M = max_batch), a prefill its prompt, a chunk its rows."""
    if kind == "tick":
        return k5_calls(s, max_batch)
    return k5_calls(s, w["tokens"] * w.get("rows", 1))
