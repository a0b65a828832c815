"""Architecture configuration system of the port.

Each architecture gets one module in this package defining an
``ArchConfig`` with the exact published dimensions, registered under its id.
``reduced()`` derives the CPU test config (same family, tiny dims).  The
fields are the JAX package's, one for one, with torch dtypes in place of jnp
ones.  ``input_specs`` gives a cell's abstract inputs (shapes, dtypes and
specs: ``models.params.AbstractLeaf``), the dry run's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

# ---------------------------------------------------------------------------
# Shape grid assigned to the LM family.
# ---------------------------------------------------------------------------
SHAPES: dict[str, dict[str, Any]] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_dtype: Any = torch.float32
    ep_axes: tuple[str, ...] = ("model",)
    padded_experts: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Family extensions ----------------------------------------------------
    moe: MoEConfig | None = None
    first_k_dense: int = 0
    mla: MLAConfig | None = None
    mtp: bool = False
    ssm: SSMConfig | None = None
    attn_every: int = 0
    encoder_layers: int = 0
    encoder_seq: int = 0
    frontend: str | None = None  # "audio" | "vision" stub (precomputed embeds)
    frontend_seq: int = 0
    # Execution knobs -------------------------------------------------------
    dtype: Any = torch.bfloat16
    activation: str = "silu"  # mlp nonlinearity family
    activation_impl: str = "exact"  # exact | pwl | lut | hard (paper RQ1 axis)
    attention_impl: str = "auto"  # auto | naive | chunked
    attn_chunk: int = 1024
    remat: str = "full"  # none | full | dots (training only; unused by serving)
    optimizer: str = "adamw"  # adamw | adafactor (training only)
    logits_chunk: int = 0  # 0 = whole-vocab CE, >0 = seq-chunked CE (training only)
    scan_layers: bool = True  # the port always loops over layers in Python
    cache_update: str = "dus"  # dus | onehot: the same cache write on one device
    kv_dtype: Any = None  # None → dtype
    # "int8" routes attention/MLP projection einsums through the int8 matmul
    # (models/quant.py): weights are quantized once at engine init,
    # activations per row at each call.  None = full-precision weights.
    quant: str | None = None

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.num_heads == 0:  # attention-free (pure SSM)
            return self.head_dim
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab rounded up to a multiple of 256; padded
        logits are masked at the sampling sites."""
        return ((self.vocab_size + 255) // 256) * 256

    def supports(self, shape_id: str) -> tuple[bool, str]:
        if shape_id == "long_500k" and self.family not in ("ssm", "hybrid"):
            return False, "full-attention arch: 500k context needs sub-quadratic attention"
        return True, ""

    def param_count(self) -> int:
        from repro_torch.models.model import param_defs
        from repro_torch.models.params import count_params

        return count_params(param_defs(self))

    def active_param_count(self) -> int:
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        epad = m.padded_experts or m.num_experts
        n_moe_layers = self.num_layers - self.first_k_dense
        return total - n_moe_layers * (epad - m.top_k) * 3 * self.d_model * m.expert_d_ff


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}
_REDUCED: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str, full: Callable[[], ArchConfig], reduced: Callable[[], ArchConfig]):
    _REGISTRY[name] = full
    _REDUCED[name] = reduced


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_reduced_config(name: str) -> ArchConfig:
    if name not in _REDUCED:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REDUCED)}")
    return _REDUCED[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Input specs (abstract stand-ins with specs, zero allocation)
# ---------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape_id: str, mesh=None) -> dict[str, Any]:
    """Abstract inputs for one (arch × shape) cell, as ``AbstractLeaf``s.

    train  → {tokens, labels [, frontend_embeds]}
    prefill→ {tokens [, frontend_embeds]}
    decode → {token, pos, cache} — cache specs come from serving.kv_cache.

    With a mesh, the batch dim is sharded by ``batch_spec`` under the active
    rules and the cache by ``_cache_spec``.
    """
    from repro_torch.models.params import AbstractLeaf, abstract_params
    from repro_torch.serving.kv_cache import cache_defs
    from repro_torch.sharding.rules import active_rules, batch_spec

    shape = SHAPES[shape_id]
    b, s = shape["global_batch"], shape["seq_len"]

    def leaf(shp, dtype):
        if mesh is None:
            return AbstractLeaf(shp, dtype)
        return AbstractLeaf(shp, dtype, batch_spec(shp[0], mesh, extra_dims=len(shp) - 1))

    out: dict[str, Any] = {}
    kind = shape["kind"]
    if kind in ("train", "prefill"):
        out["tokens"] = leaf((b, s), torch.int32)
        if kind == "train":
            out["labels"] = leaf((b, s), torch.int32)
        if cfg.frontend == "vision":
            out["frontend_embeds"] = leaf((b, cfg.frontend_seq, cfg.d_model), cfg.dtype)
        if cfg.frontend == "audio":
            out["frontend_embeds"] = leaf((b, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    else:  # decode: one new token against a seq_len KV cache
        out["token"] = leaf((b, 1), torch.int32)
        out["pos"] = AbstractLeaf((), torch.int32, None if mesh is None else ())
        defs = cache_defs(cfg, batch=b, max_len=s)
        rules = active_rules()
        if mesh is None:
            out["cache"] = abstract_params(defs)
        else:
            out["cache"] = abstract_params(defs, lambda d: _cache_spec(d, b, mesh, rules))
    return out


def _cache_spec(d, batch: int, mesh, rules) -> tuple:
    """KV-cache spec: batch dim over DP axes (if divisible), seq over TP."""
    from repro_torch.sharding.rules import axis_sizes, batch_axes, spec_for

    base = spec_for(d, mesh, rules)
    axes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    entries = list(base)
    for i, (dim, logical) in enumerate(zip(d.shape, d.logical)):
        if logical == "batch" and dim % size == 0 and size > 1:
            entries[i] = axes if len(axes) > 1 else axes[0]
    return tuple(entries)
