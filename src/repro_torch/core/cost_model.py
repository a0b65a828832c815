"""Roofline arithmetic on the H100 (the Generator's estimation stage).

The paper's Generator prunes candidates with *analytical models* before any
expensive evaluation (§2.2).  This module is the roofline core of that
model for the card, as the block-size tuner (``kernels/autotune.py``) uses
it:

  compute term    = operations / the peak rate of the operands' type
  memory term     = device-memory bytes / HBM bandwidth
  collective term = bytes between cards / NVLink bandwidth each way

T_step = max(terms) (perfect overlap; the sum is the no-overlap bound, both
reported).  Energy = T_step · chips · P(util), with the linear idle→peak
power model of ``core.energy.H100Chip``.

Unlike the TPU, whose matrix unit runs f32 products through its bf16 path,
the H100 runs IEEE f32 multiply-adds on its CUDA cores at 67 TFLOP/s, a
fifteenth of the bf16 tensor-core rate: :func:`chip_for_dtype` scores f32
work against that rate.

The per-architecture step estimates (:func:`estimate_step` over a
:class:`MeshPlan`, the FLOP and HBM-byte models) and :class:`GPUCostBackend`,
the Generator's backend for a served or trained model, are the reference's
arithmetic operation for operation, scored on :class:`H100Chip`: bf16
products at ``peak_flops``, HBM at ``hbm_bw``, bytes between cards at
``link_bw`` (NVLink within one 8-GPU node: a plan whose tensor-parallel
group spans nodes is costed as if it did not).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.core.candidates import DesignPoint, Estimate
from repro_torch.core.energy import DEFAULT_CHIP, H100Chip
from repro_torch.models.activations import VARIANT_COST, VARIANT_ERROR

BF16 = 2  # bytes
F32 = 4
INT8 = 1

# Bytes per element for the dtype strings that flow through the kernel layer
# (tuner cache keys use the dtype's name; quantized paths use "int8").
DTYPE_BYTES = {
    "float64": 8,
    "float32": F32,
    "float16": 2,
    "bfloat16": BF16,
    "int8": INT8,
    "int32": 4,
}


def dtype_bytes(dtype: str) -> int:
    """Bytes/element for a dtype string; substrings accepted ("int8" in
    "lstm-int8"). Unknown dtypes conservatively cost f32."""
    if dtype in DTYPE_BYTES:
        return DTYPE_BYTES[dtype]
    for name, nbytes in DTYPE_BYTES.items():
        if name in dtype:
            return nbytes
    return F32


def chip_for_dtype(chip: H100Chip, dtype: str) -> H100Chip:
    """Chip whose ``peak_flops`` is the rate that runs ``dtype``'s products:
    int8 on the tensor cores at 1979 TOP/s, bf16 and fp16 there at 989
    TFLOP/s, and anything else (f32 above all) on the CUDA cores at 67."""
    if "int8" in dtype:
        return dataclasses.replace(chip, peak_flops=chip.peak_int8_ops)
    if "bfloat16" in dtype or "float16" in dtype:
        return chip
    return dataclasses.replace(chip, peak_flops=chip.peak_f32_flops)


def arithmetic_intensity(flops: float, hbm_bytes: float) -> float:
    """Ops per device-memory byte — the roofline x-axis."""
    return flops / hbm_bytes if hbm_bytes else float("inf")


def ridge_intensity(chip: H100Chip = DEFAULT_CHIP, *, dtype: str = "bfloat16") -> float:
    """Intensity at which compute and memory terms tie (ops/byte)."""
    return chip_for_dtype(chip, dtype).peak_flops / chip.hbm_bw


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Three-term roofline for one execution.  ``chip.peak_flops`` is the
    rate the work is scored against: pass ``chip_for_dtype(chip, dtype)``."""

    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    chips: int
    model_flops: float  # useful FLOPs, GLOBAL
    chip: H100Chip = DEFAULT_CHIP

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / self.chip.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_dev / self.chip.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_dev / self.chip.link_bw

    @property
    def t_step_s(self) -> float:
        """Perfect-overlap bound: slowest resource wins."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def t_step_noverlap_s(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """Useful FLOPs over executed FLOPs."""
        total = self.flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the perfect-overlap step time."""
        if self.t_step_s <= 0:
            return 0.0
        return self.model_flops / (self.t_step_s * self.chips * self.chip.peak_flops)

    @property
    def roofline_fraction(self) -> float:
        return self.mfu

    def energy_j(self) -> float:
        util = self.compute_s / self.t_step_s if self.t_step_s else 0.0
        return self.t_step_s * self.chips * self.chip.step_power(util)

    def flops_per_joule(self) -> float:
        e = self.energy_j()
        return self.model_flops / e if e else 0.0

    def summary(self) -> dict[str, Any]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "t_step_s": self.t_step_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "mfu": self.mfu,
            "energy_j": self.energy_j(),
            "gflops_per_j": self.flops_per_joule() / 1e9,
        }


# ---------------------------------------------------------------------------
# Analytical per-arch step estimates
# ---------------------------------------------------------------------------
def matmul_params(cfg: ArchConfig) -> int:
    """Params participating in per-token matmuls (embeddings excluded,
    unembedding included — it is a real matmul)."""
    total = cfg.param_count()
    embed = cfg.padded_vocab * cfg.d_model  # token table (gather, not matmul)
    return total - embed


def active_matmul_params(cfg: ArchConfig) -> int:
    inactive = cfg.param_count() - cfg.active_param_count()
    return matmul_params(cfg) - inactive


def attention_flops(cfg: ArchConfig, batch: int, seq: int, *, causal_discount: bool = False) -> float:
    """Score+PV matmul FLOPs for one full forward (GQA or MLA), all layers."""
    if cfg.family == "ssm":
        return _ssd_flops(cfg, batch, seq)
    if cfg.family == "hybrid":
        n_apps = math.ceil(cfg.num_layers / cfg.attn_every)
        attn = 4.0 * batch * seq * seq * cfg.num_heads * cfg.resolved_head_dim * n_apps
        return attn * (0.5 if causal_discount else 1.0) + _ssd_flops(cfg, batch, seq)
    if cfg.mla is not None:
        hd = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim + cfg.mla.v_head_dim
    else:
        hd = 2 * cfg.resolved_head_dim
    layers = cfg.num_layers + cfg.encoder_layers
    f = 2.0 * batch * seq * seq * cfg.num_heads * hd * layers
    return f * (0.5 if causal_discount else 1.0)


def _ssd_flops(cfg: ArchConfig, batch: int, seq: int) -> float:
    """Mamba2 chunked-SSD matmul FLOPs (intra-chunk quadratic + states)."""
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    L = s.chunk_size
    n = s.state_size
    per_layer = (
        2.0 * batch * seq * L * n            # C·Bᵀ within chunks
        + 2.0 * batch * seq * L * d_in       # (CB∘seg)·x
        + 4.0 * batch * seq * d_in * n       # chunk states in/out
    )
    return per_layer * cfg.num_layers


def train_model_flops(cfg: ArchConfig, batch: int, seq: int) -> float:
    """Useful FLOPs: 6·N_active·tokens + attention (fwd+bwd, causal)."""
    tokens = batch * seq
    return 6.0 * active_matmul_params(cfg) * tokens + 3.0 * attention_flops(
        cfg, batch, seq, causal_discount=True
    )


def prefill_model_flops(cfg: ArchConfig, batch: int, seq: int) -> float:
    """Forward-only useful FLOPs; unembedding applies to the LAST token."""
    tokens = batch * seq
    unembed = cfg.d_model * cfg.padded_vocab
    body = 2.0 * (active_matmul_params(cfg) - unembed) * tokens
    return body + 2.0 * unembed * batch + attention_flops(
        cfg, batch, seq, causal_discount=True
    )


def decode_model_flops(cfg: ArchConfig, batch: int, ctx: int) -> float:
    """Useful FLOPs for one decode step: 2·N_active·B + attention reads."""
    f = 2.0 * active_matmul_params(cfg) * batch
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        d_in = s.d_inner(cfg.d_model)
        f += 4.0 * batch * d_in * s.state_size * cfg.num_layers  # state update+out
        if cfg.family == "hybrid":
            n_apps = math.ceil(cfg.num_layers / cfg.attn_every)
            f += 4.0 * batch * ctx * cfg.num_heads * cfg.resolved_head_dim * n_apps
    elif cfg.mla is not None:
        m = cfg.mla
        f += 2.0 * batch * ctx * cfg.num_heads * (m.kv_lora_rank * 2 + m.qk_rope_head_dim) * cfg.num_layers
    else:
        f += 4.0 * batch * ctx * cfg.num_heads * cfg.resolved_head_dim * cfg.num_layers
    return f


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The distribution shape the analytical model costs against."""

    dp: int = 1     # data-parallel ways (pod × data axes)
    tp: int = 1     # tensor/expert-parallel ways ("model" axis)
    fsdp: bool = False

    @property
    def chips(self) -> int:
        return self.dp * self.tp


def _param_bytes(cfg: ArchConfig, dtype_bytes: int = BF16) -> float:
    return float(cfg.param_count()) * dtype_bytes


# ---------------------------------------------------------------------------
# Analytical HBM-traffic model (the roofline memory term).
#
# The memory term is an explicit per-term analytical model — the paper's own
# methodology (analytical models for exploration, §2.2) — whose terms are
# returned one by one so that each can be held against a measurement.
#
# Conventions: one WRITE + one READ per major intermediate (fused
# elementwise ops are free); backward reads saved/recomputed activations and
# writes/reads gradient tensors; f32 where the implementation keeps f32.
# ---------------------------------------------------------------------------
def _act_elems_per_token_layer(cfg: ArchConfig, tp: int) -> float:
    """Major intermediate ELEMENTS per token per layer per device (already
    divided by tp where the tensor is tp-sharded; d_model-wide tensors are
    replicated across tp)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm.d_inner(d)
        n = cfg.ssm.state_size
        # z/x conv B/C/dt streams + gated out (sharded) + 2 ln/residual (repl)
        elems = 4 * d + (8.0 * di) / tp + 4 * n
        if cfg.family == "hybrid":
            n_apps = math.ceil(cfg.num_layers / cfg.attn_every)
            attn = (4 * cfg.num_heads * hd + 3 * cfg.d_ff) / tp + 4 * d
            elems += attn * n_apps / cfg.num_layers
        return elems
    if cfg.mla is not None:
        m = cfg.mla
        qkv = (
            m.q_lora_rank + m.kv_lora_rank + m.qk_rope_head_dim
            + cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim + 2 * m.v_head_dim)
        )
    else:
        qkv = (2 * cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    if cfg.moe is not None:
        mo = cfg.moe
        ff = 3 * (mo.top_k * mo.expert_d_ff + mo.num_shared * mo.shared_d_ff)
        k_dense = cfg.first_k_dense
        if k_dense:
            ff = (ff * (cfg.num_layers - k_dense) + 3 * cfg.d_ff * k_dense) / cfg.num_layers
    else:
        ff = 3 * cfg.d_ff
    return 4 * d + (qkv + ff) / tp


def _attn_scores_bytes(cfg: ArchConfig, b_dev: float, sq: int, sk: int, tp: int) -> float:
    """f32 score/prob matrices hitting HBM per LAYER per device for the
    naive/chunked plain-torch paths. A flash kernel keeps these on chip —
    selecting it zeroes this term (a generator design axis)."""
    if cfg.family == "ssm":
        L = cfg.ssm.chunk_size  # intra-chunk (L×L) seg matrices
        return 2.0 * b_dev * sq * L * F32
    heads = cfg.num_heads / min(tp, cfg.num_heads)
    per_layer = 2.0 * b_dev * heads * sq * sk * F32  # scores + probs
    if cfg.family == "hybrid":
        n_apps = math.ceil(cfg.num_layers / cfg.attn_every)
        ssm_part = 2.0 * b_dev * sq * cfg.ssm.chunk_size * F32
        return per_layer * n_apps / cfg.num_layers + ssm_part
    return per_layer


def hbm_bytes_terms(
    cfg: ArchConfig,
    shape_id: str,
    plan: MeshPlan,
    *,
    remat: str | None = None,
    attention_impl: str | None = None,
) -> dict[str, float]:
    """Per-device HBM bytes for one step, split into auditable terms."""
    sh = SHAPES[shape_id]
    b, s = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    remat = remat or cfg.remat
    attention_impl = attention_impl or cfg.attention_impl
    tokens_dev = b * s / plan.dp
    b_dev = b / plan.dp
    elems = _act_elems_per_token_layer(cfg, plan.tp)
    layers = cfg.num_layers + cfg.encoder_layers

    p_elems_dev = cfg.param_count() / (plan.tp * (plan.dp if plan.fsdp else 1))
    w_read = p_elems_dev * BF16  # one full weight sweep

    terms: dict[str, float] = {}
    if kind == "decode":
        from repro_torch.serving.kv_cache import cache_bytes  # a cycle at import time

        # every device re-reads its own weight shard each step; under FSDP
        # the contraction-dim sharding means no gather — just partial-sum
        # activation all-reduces (confirmed in the compiled collectives)
        terms["weights"] = p_elems_dev * BF16
        terms["kv_cache"] = cache_bytes(cfg, batch=b, max_len=s) / plan.chips
        terms["activations"] = b_dev * elems * layers * BF16
        terms["logits"] = b_dev * cfg.padded_vocab / plan.tp * F32 * 2
        terms["total"] = sum(terms.values())
        return terms

    # train / prefill forward activation traffic
    act_fwd = 2.0 * tokens_dev * elems * layers * BF16  # write + read
    scores_fwd = (
        0.0
        if attention_impl == "flash"
        else _attn_scores_bytes(cfg, b_dev, s, s, plan.tp) * layers
    )
    logits = 3.0 * tokens_dev * cfg.padded_vocab / plan.tp * F32

    if kind == "prefill":
        from repro_torch.serving.kv_cache import cache_bytes  # a cycle at import time

        terms["weights"] = w_read
        terms["activations"] = act_fwd
        terms["attn_scores"] = scores_fwd
        terms["kv_cache_write"] = cache_bytes(cfg, batch=b, max_len=s) / plan.chips
        terms["logits"] = b_dev * cfg.padded_vocab / plan.tp * F32 * 2
        terms["total"] = sum(terms.values())
        return terms

    # -- train ---------------------------------------------------------------
    terms["weights_fwd"] = w_read
    terms["weights_bwd"] = w_read
    remat_mult = {"full": 1.0, "dots": 0.5, "none": 0.0}[remat]
    terms["weights_remat"] = remat_mult * w_read
    # gradients: write f32, read by optimizer
    terms["grads"] = 2.0 * p_elems_dev * F32
    # optimizer state read+write (adamw: m, v, f32 master weights)
    opt_elems = 3.0 * p_elems_dev if cfg.optimizer == "adamw" else 0.05 * p_elems_dev
    terms["optimizer"] = 2.0 * opt_elems * F32 + p_elems_dev * BF16  # + param write
    # activations: fwd (2) + bwd reads/grad traffic (3) + remat recompute (2)
    act_mult = 5.0 + 2.0 * remat_mult
    terms["activations"] = act_mult / 2.0 * act_fwd
    terms["attn_scores"] = (2.0 if remat != "none" else 1.0) * scores_fwd + scores_fwd
    terms["logits"] = logits
    terms["total"] = sum(terms.values())
    return terms


def estimate_train_step(
    cfg: ArchConfig,
    shape_id: str,
    plan: MeshPlan,
    point: DesignPoint | None = None,
    chip: H100Chip = DEFAULT_CHIP,
) -> Roofline:
    """Analytical roofline for one training step (per-device quantities)."""
    sh = SHAPES[shape_id]
    b, s = sh["global_batch"], sh["seq_len"]
    tokens = b * s
    p = point or DesignPoint.of()
    remat = p.get("remat", cfg.remat)
    act_impl = p.get("activation_impl", cfg.activation_impl)

    n_active = active_matmul_params(cfg)
    attn = attention_flops(cfg, b, s, causal_discount=False)  # full matmuls, as a compiler issues them
    fwd = 2.0 * n_active * tokens + attn
    bwd = 2.0 * fwd
    recompute = fwd if remat == "full" else (0.3 * fwd if remat == "dots" else 0.0)
    # activation-variant VPU overhead folded in as FLOP-equivalents
    act_ops = VARIANT_COST[act_impl] * tokens * cfg.d_ff * max(cfg.num_layers, 1) * 0.0  # negligible vs matmuls
    flops_global = fwd + bwd + recompute + act_ops
    flops_dev = flops_global / plan.chips

    # -- HBM bytes (per device): shared analytical traffic model ------------
    bytes_dev = hbm_bytes_terms(
        cfg, shape_id, plan, remat=remat,
        attention_impl=p.get("attention_impl", cfg.attention_impl),
    )["total"]
    pb = _param_bytes(cfg)
    pb_dev = pb / (plan.tp * (plan.dp if plan.fsdp else 1))

    # -- collective bytes (per device) --------------------------------------
    coll = 0.0
    grad_dev = pb_dev
    if plan.dp > 1:
        coll += 2.0 * grad_dev * (plan.dp - 1) / plan.dp  # ring all-reduce (or RS+AG under fsdp)
        if plan.fsdp:
            coll += 2.0 * pb_dev * (plan.dp - 1) / plan.dp  # fwd+bwd weight all-gathers
    if plan.tp > 1:
        act_layer = (tokens / plan.dp) * cfg.d_model * BF16
        n_sync = 2 * (cfg.num_layers + cfg.encoder_layers)  # attn + mlp epilogues
        coll += n_sync * 2.0 * act_layer * (plan.tp - 1) / plan.tp / plan.tp
        if cfg.moe is not None:
            cap = cfg.moe.top_k * cfg.moe.capacity_factor
            a2a = (tokens / plan.dp) * cap * cfg.d_model * BF16
            coll += 4.0 * a2a / plan.tp  # dispatch+return, fwd+bwd

    return Roofline(
        flops_per_dev=flops_dev,
        hbm_bytes_per_dev=bytes_dev,
        coll_bytes_per_dev=coll,
        chips=plan.chips,
        model_flops=train_model_flops(cfg, b, s),
        chip=chip,
    )


def estimate_decode_step(
    cfg: ArchConfig,
    shape_id: str,
    plan: MeshPlan,
    point: DesignPoint | None = None,
    chip: H100Chip = DEFAULT_CHIP,
) -> Roofline:
    """Analytical roofline for one decode step (one token, KV ctx = seq_len)."""
    sh = SHAPES[shape_id]
    b, ctx = sh["global_batch"], sh["seq_len"]
    n_active = active_matmul_params(cfg)

    flops_global = decode_model_flops(cfg, b, ctx)
    flops_dev = flops_global / plan.chips

    bytes_dev = hbm_bytes_terms(cfg, shape_id, plan)["total"]

    coll = 0.0
    if plan.tp > 1:
        act = (b / max(plan.dp, 1)) * cfg.d_model * BF16
        n_sync = 2 * cfg.num_layers
        coll += n_sync * 2.0 * act * (plan.tp - 1) / plan.tp / plan.tp

    return Roofline(
        flops_per_dev=flops_dev,
        hbm_bytes_per_dev=bytes_dev,
        coll_bytes_per_dev=coll,
        chips=plan.chips,
        model_flops=decode_model_flops(cfg, b, ctx),
        chip=chip,
    )


def estimate_step(cfg, shape_id, plan, point=None, chip=DEFAULT_CHIP) -> Roofline:
    kind = SHAPES[shape_id]["kind"]
    if kind == "train":
        return estimate_train_step(cfg, shape_id, plan, point, chip)
    if kind == "decode":
        return estimate_decode_step(cfg, shape_id, plan, point, chip)
    # prefill ≈ train forward only
    r = estimate_train_step(cfg, shape_id, plan, point, chip)
    return dataclasses.replace(
        r,
        flops_per_dev=r.flops_per_dev / 3.0,
        hbm_bytes_per_dev=r.hbm_bytes_per_dev / 3.0,
        coll_bytes_per_dev=r.coll_bytes_per_dev / 3.0,
        model_flops=r.model_flops / 3.0,
    )


# ---------------------------------------------------------------------------
# GPU cost backend for the Generator (serving-oriented design space)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GPUCostBackend:
    """Per-(arch × shape × mesh) analytical backend, the reference's
    ``TPUCostBackend`` on :class:`H100Chip`.

    Design axes mirror the FPGA backend's RTL-template axes, re-costed for
    the card: activation impl, attention impl, precision, remat, layer scan;
    the Estimate feeds the same Generator/strategy machinery.  int8 scales
    the compute term by ``peak_flops / peak_int8_ops`` and the bytes by 0.6;
    reload and power come from the chip, the collective term from its
    ``link_bw``.
    """

    cfg: ArchConfig
    shape_id: str
    plan: MeshPlan
    chip: H100Chip = DEFAULT_CHIP

    def space(self) -> dict[str, tuple]:
        axes: dict[str, tuple] = {
            "activation_impl": ("exact", "pwl", "lut", "hard"),
            "precision": ("bf16", "int8"),
        }
        kind = SHAPES[self.shape_id]["kind"]
        if kind == "train":
            axes["remat"] = ("none", "dots", "full")
            axes["scan_layers"] = (True, False)
        if self.cfg.family not in ("ssm",):
            axes["attention_impl"] = ("naive", "chunked")
        return axes

    def evaluate(self, point: DesignPoint) -> Estimate:
        r = estimate_step(self.cfg, self.shape_id, self.plan, point, self.chip)
        precision = point.get("precision", "bf16")
        flops_dev = r.flops_per_dev
        bytes_dev = r.hbm_bytes_per_dev
        if precision == "int8":
            flops_dev /= self.chip.peak_int8_ops / self.chip.peak_flops  # int8 tensor cores, 2× the bf16 rate
            bytes_dev *= 0.6  # weights+activations halve; f32 master copies don't
        r2 = dataclasses.replace(r, flops_per_dev=flops_dev, hbm_bytes_per_dev=bytes_dev)
        t = r2.t_step_s
        util = r2.compute_s / t if t else 0.0
        p_active = self.chip.step_power(util)
        weight_bytes = _param_bytes(self.cfg) / self.plan.tp
        return Estimate(
            latency_s=t,
            power_active_w=p_active * r2.chips,
            power_idle_w=self.chip.p_idle_w * r2.chips,
            energy_per_inf_j=t * p_active * r2.chips,
            resources={
                "hbm_bytes": bytes_per_device_estimate(self.cfg, self.shape_id, self.plan),
                "chips": r2.chips,
            },
            max_act_error=VARIANT_ERROR[point.get("activation_impl", "exact")]
            + (5e-3 if precision == "int8" else 0.0),
            cfg_energy_j=self.chip.reload_time(weight_bytes)
            * self.chip.p_idle_w
            * r2.chips,
            cfg_time_s=self.chip.reload_time(weight_bytes),
            ops=r2.model_flops,
        )

    def feasible(self, point: DesignPoint) -> tuple[bool, str]:
        hbm = bytes_per_device_estimate(self.cfg, self.shape_id, self.plan)
        if hbm > self.chip.hbm_bytes:
            return False, f"est. {hbm / 1e9:.1f} GB/device > {self.chip.hbm_bytes / 1e9:.0f} GB HBM"
        return True, ""


def bytes_per_device_estimate(cfg: ArchConfig, shape_id: str, plan: MeshPlan) -> float:
    """Resident bytes/device: weights (+opt states for train) + cache/activations."""
    sh = SHAPES[shape_id]
    pb = _param_bytes(cfg)
    pb_dev = pb / (plan.tp * (plan.dp if plan.fsdp else 1))
    if sh["kind"] == "train":
        opt = 3 * pb_dev * (F32 / BF16) if cfg.optimizer == "adamw" else 0.25 * pb_dev
        grads = pb_dev
        act = sh["global_batch"] * sh["seq_len"] / plan.chips * cfg.d_model * BF16 * (
            2 if cfg.remat == "full" else 2 * max(cfg.num_layers // 4, 1)
        )
        return pb_dev + opt + grads + act
    from repro_torch.serving.kv_cache import cache_bytes  # a cycle at import time

    kv = cache_bytes(cfg, batch=sh["global_batch"], max_len=sh["seq_len"]) / plan.chips
    return pb_dev + kv  # FSDP shards inference weights too (contraction-dim)
