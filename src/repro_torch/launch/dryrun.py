"""Multi-pod dry run: every cell's distribution config, as arithmetic and
as the real step traced on fake tensors.

For every (architecture × input shape) cell and both production meshes
(single-pod 16×16, multi-pod 2×16×16) ``cell_arithmetic`` lays out the REAL
step's inputs (the params and optimizer state of
``training.train_loop.abstract_state``, the batch and caches of
``configs.input_specs``) by the sharding rules on the mesh's shape, and
reports per device:

  * the resident bytes of those inputs (their shard shapes) and whether they
    fit ``core.energy.H100Chip``'s 80 GB of HBM;
  * the step's model FLOPs and the step cost model's terms
    (``core.cost_model``: ``hbm_bytes_terms``, ``estimate_step``);
  * the collective bytes one step of the port sends, counted from the
    placements and shapes (``training.train_loop.step_collectives`` for a
    train cell; the weight gathers, the tensor-parallel sums and the sharded
    MoE's forward for prefill and decode, and a decode step's flash-decoding
    collectives: ``forward_collectives``).

The reference (``repro.launch.dryrun``) lowers and compiles each cell
through GSPMD on 512 forced host devices and reads the compiled module.
The port traces it instead (``run_cell``, ``lower_cell``): rank 0's real
step (``make_mesh_step``; for a prefill ``make_mesh_prefill``, for a decode
``make_mesh_decode`` over the rank's block of the cache, its sequence axis
split over "model") runs once on
fake tensors over a fake process group of the mesh's 256 or 512 ranks
(``launch.trace``), nothing allocated and no device touched, and the cell
gets, per device, the step's matmul FLOPs (``cost_analysis``, with the
depth fit over two traced depths, ``depth_fit_analysis``), its peak live
bytes and their breakdown (``live_bytes_per_dev``, ``fits_hbm_live``,
``memory_analysis``), the collectives it sent (``collectives.traced``,
beside the analytic count) and the trace's wall time (``lower_s``).  There
is no compile and no HLO: ``compile_s``, ``hlo_bytes`` and
``collectives.hlo`` stay ``null``.  The figures are CPU traces of the
port's code, not times on a card.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes]
  python -m repro_torch.launch.dryrun --arch X --shape Y --override remat=none
  python -m repro_torch.launch.dryrun --table --out DIR     # the traced cells in DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
from typing import Any

import torch

from repro_torch.configs import SHAPES, get_config, input_specs, list_archs
from repro_torch.configs.base import ArchConfig, _cache_spec
from repro_torch.core import collectives as C
from repro_torch.core.cost_model import (
    MeshPlan,
    decode_model_flops,
    estimate_step,
    hbm_bytes_terms,
    prefill_model_flops,
    train_model_flops,
)
from repro_torch.core.energy import DEFAULT_CHIP
from repro_torch.models import moe
from repro_torch.models.layers import vocab_split
from repro_torch.models.model import (
    _mask_pad_logits,
    decode_step,
    init_model,
    param_defs,
    prefill,
)
from repro_torch.models.params import abstract_params, tree_flatten, tree_unflatten
from repro_torch.serving.kv_cache import cache_defs
from repro_torch.sharding import layout
from repro_torch.sharding.rules import (
    MODEL,
    MeshShape,
    activate_mesh,
    axis_sizes,
    make_rules,
    shard_shape,
    spec_for,
)
from repro_torch.training import train_loop
from repro_torch.training.optimizer import init_opt_state

OUT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_dryrun")


def default_fsdp(cfg: ArchConfig) -> bool:
    """ZeRO-3 weight sharding on once weights+opt exceed TP-only HBM."""
    return cfg.param_count() > 10e9


def apply_overrides(cfg: ArchConfig, overrides: dict[str, Any]) -> ArchConfig:
    if not overrides:
        return cfg
    overrides = dict(overrides)
    for k, v in overrides.items():
        if k.endswith("dtype") and isinstance(v, str):  # e.g. kv_dtype=float8_e4m3fn
            overrides[k] = getattr(torch, v)
    return dataclasses.replace(cfg, **overrides)


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    """``launch.mesh.make_production_mesh``'s shape, with no process group."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


def cell_inputs(cfg: ArchConfig, shape_id: str, mesh, rules) -> tuple:
    """The step's abstract inputs on ``mesh`` (under ``activate_mesh``)."""
    kind = SHAPES[shape_id]["kind"]
    if kind == "train":
        params_abs, opt_abs = train_loop.abstract_state(cfg, mesh, rules)
        return params_abs, opt_abs, input_specs(cfg, shape_id, mesh)
    params_abs = abstract_params(param_defs(cfg), lambda d: spec_for(d, mesh, rules))
    spec = input_specs(cfg, shape_id, mesh)
    if kind == "prefill":
        return params_abs, spec
    cache_abs = spec.pop("cache")
    return params_abs, cache_abs, spec


def resident_bytes_per_device(inputs, mesh) -> int:
    """Mesh-exact bytes/device of all inputs (weights+opt+cache+batch)."""
    return sum(math.prod(leaf.shard_shape(mesh)) * leaf.dtype.itemsize
               for leaf in tree_flatten(inputs))


def model_flops_of(cfg: ArchConfig, shape_id: str) -> float:
    sh = SHAPES[shape_id]
    b, s = sh["global_batch"], sh["seq_len"]
    if sh["kind"] == "train":
        return train_model_flops(cfg, b, s)
    if sh["kind"] == "prefill":
        return prefill_model_flops(cfg, b, s)
    return decode_model_flops(cfg, b, s)


def forward_collectives(cfg: ArchConfig, mesh, rules, batch: int, seq: int, *,
                        decode: bool = False, dtype=None) -> C.CollectiveStats:
    """What a forward pass (prefill, a decode step) of the port sends from
    each rank: the weight gathers to the compute layout, the
    tensor-parallel sums of the embedding and the layers
    (``train_loop.tp_collectives``: every kind but the loss's and the MTP
    head's, which only training runs, and with ``decode`` but whisper's
    encoder's: a decode step reads the cross K/V its prompt's prefill
    left), the last position's logits (f32)
    gathered over "model" where the vocabulary is split, and each MoE
    layer's forward on the rank's tokens.  With ``decode``, ``seq`` is the
    cache's capacity, the step runs one token a row, and its attention
    layers' flash-decoding collectives and the Mamba2 conv rows are added
    (``decode_collectives``).  ``dtype``: the params' and the activations'
    dtype where it is not the ParamDefs' and the config's (a state cast to
    f32), as ``train_loop.step_collectives`` takes it."""
    tokens = 1 if decode else seq
    lay = train_loop.MeshLayout(cfg, mesh, rules, batch, tokens)
    stats = C.CollectiveStats()
    if mesh.size() == 1:
        return stats
    for d, s, c in zip(lay.param_defs, lay.param_specs, lay.compute_specs):
        layout.relayout_sends(d.shape, dtype or d.dtype, mesh, s, c, stats)
    tp = train_loop.tp_collectives(lay, lay.local_batch, tokens, dtype or cfg.dtype, dtype)
    for what, nbytes, count, _ in tp:
        if what in ("layer", "norm", "shared", "embed") or (what == "encoder" and not decode):
            stats.add("all-reduce", nbytes, count)
    if any(what == "loss" for what, *_ in tp):  # the vocabulary is split
        stats.add("all-gather",
                  4 * lay.local_batch * cfg.padded_vocab // axis_sizes(mesh)[MODEL])
    if cfg.moe is not None:
        stats.merge(moe.moe_collectives(cfg, mesh, lay.local_batch, tokens, dtype or cfg.dtype),
                    cfg.num_layers - cfg.first_k_dense)
    if decode:
        decode_collectives(lay, seq, stats, dtype)
    return stats


def decode_cache_specs(cfg: ArchConfig, mesh, rules, batch: int, capacity: int) -> dict:
    """{cache key: (ParamDef, the spec of its block on ``mesh``)}: the
    decode cache of ``batch`` rows and ``capacity`` positions laid out by
    ``configs.base._cache_spec`` (its batch over the data axes where they
    divide it, its sequence over "model")."""
    with activate_mesh(mesh, rules):
        return {k: (d, _cache_spec(d, batch, mesh, rules))
                for k, d in cache_defs(cfg, batch=batch, max_len=capacity).items()}


def decode_collectives(lay: train_loop.MeshLayout, capacity: int, stats: C.CollectiveStats,
                       dtype=None) -> None:
    """Adds to ``stats`` what a decode step's attention and Mamba2 layers
    send beyond the tensor-parallel sums, layer by layer
    (``models/layers.py``'s flash-decoding): the gathers over "model" of the
    step's q, k and v (GQA; MLA's absorbed q and its q_rope; whisper's
    cross-attention q) where the rank holds a block of their heads, in the
    activations' dtype; on a cache split over "model" on its positions, the
    softmax's max, its sum (f32, one a row and head) and the P·V partial
    (f32); and a Mamba2 layer's new x row of its conv window, gathered where
    the block computes on its heads."""
    cfg, mesh = lay.cfg, lay.mesh
    if axis_sizes(mesh).get(MODEL, 1) == 1:
        return
    b, act = lay.local_batch, (dtype or cfg.dtype).itemsize
    compute = dict(zip(lay.paths, lay.compute_specs))
    caches = decode_cache_specs(cfg, mesh, lay.rules, lay.global_batch, capacity)

    defs = dict(zip(lay.paths, lay.param_defs))

    def positions_split(key: str) -> bool:
        return MODEL in caches[key][1]

    def gathers(path: tuple, row: int, count: int, n: int = 1, dim: int = -2) -> None:
        """``n`` gathers a layer of a (b, 1, heads, row) block, the heads
        (or Mamba2's x channels) those of ``path``'s ``dim`` on the rank."""
        if MODEL in compute[path]:
            heads = shard_shape(defs[path].shape, compute[path], mesh)[dim]
            stats.add("all-gather", b * heads * row * act, n * count)

    def partials(key: str, width: int, count: int) -> None:
        if positions_split(key):
            stats.add("all-reduce", 4 * b * cfg.num_heads, 2 * count)  # the max and the sum
            stats.add("all-reduce", 4 * b * cfg.num_heads * width, count)  # P·V

    hd = cfg.resolved_head_dim
    if cfg.family in ("ssm", "hybrid"):
        gathers(("blocks", "mamba", "wx"), 1, cfg.num_layers, dim=-1)
    if cfg.family == "hybrid":
        apps = len(range(0, cfg.num_layers, cfg.attn_every))
        gathers(("shared", "attn", "wq"), hd, apps)
        gathers(("shared", "attn", "wk"), hd, apps, 2)
        partials("shared_k", hd, apps)
    elif cfg.mla is not None:
        m = cfg.mla
        for stack in ("dense_blocks", "blocks"):
            if (stack, "attn", "wk_b") not in compute:
                continue
            n = defs[(stack, "attn", "wk_b")].shape[0]
            gathers((stack, "attn", "wk_b"), m.kv_lora_rank, n)  # q_abs
            gathers((stack, "attn", "wk_b"), m.qk_rope_head_dim, n)  # q_rope
            partials("c", m.kv_lora_rank, n)
    elif cfg.family != "ssm":
        attn = "self_attn" if cfg.family == "audio" else "attn"
        gathers(("blocks", attn, "wq"), hd, cfg.num_layers)
        gathers(("blocks", attn, "wk"), hd, cfg.num_layers, 2)
        partials("k", hd, cfg.num_layers)
        if cfg.family == "audio" and positions_split("cross_k"):  # else gqa_cross_apply's dataflow
            gathers(("blocks", "cross_attn", "wq"), hd, cfg.num_layers)
            partials("cross_k", hd, cfg.num_layers)


def cell_collectives(cfg: ArchConfig, shape_id: str, mesh, rules) -> C.CollectiveStats:
    sh = SHAPES[shape_id]
    b, s = sh["global_batch"], sh["seq_len"]
    if sh["kind"] == "train":
        return train_loop.step_collectives(cfg, mesh, rules, b, s)
    if sh["kind"] == "prefill":
        return forward_collectives(cfg, mesh, rules, b, s)
    return forward_collectives(cfg, mesh, rules, b, s, decode=True)


# ---------------------------------------------------------------------------
# Cell tracing: the rank's real step on fake tensors over a fake world
# ---------------------------------------------------------------------------
def rank_batch(cfg: ArchConfig, kind: str, batch: int, seq: int) -> dict:
    """A rank's ``batch`` x ``seq`` slice of a train or prefill batch
    (``Trainer.batch``'s shapes and dtypes; zeros); of a decode step, its
    ``batch`` tokens and the position they are written at (a 0-d int32, as
    ``configs.input_specs`` gives it)."""
    if kind == "decode":
        return {"token": torch.zeros((batch, 1), dtype=torch.int32),
                "pos": torch.zeros((), dtype=torch.int32)}
    out = {"tokens": torch.zeros((batch, seq), dtype=torch.int32)}
    if kind == "train":
        out["labels"] = torch.zeros((batch, seq), dtype=torch.int32)
    rows = {"vision": cfg.frontend_seq, "audio": cfg.encoder_seq}.get(cfg.frontend)
    if rows is not None:
        out["frontend_embeds"] = torch.zeros((batch, rows, cfg.d_model), dtype=cfg.dtype)
    return out


def make_mesh_prefill(cfg: ArchConfig, lay: train_loop.MeshLayout):
    """Returns prefill(params, batch) → (logits (B_l, V) f32, cache) for one
    rank of ``lay.mesh``: the params (DTensors of the rank's blocks)
    relayouted to the compute layout as ``make_mesh_step`` does, ``prefill``
    on the rank's slice under the mesh, and the last position's logits
    gathered over "model" where the vocabulary is split
    (``forward_collectives`` counts what it sends)."""
    mesh = lay.mesh

    def run(params, batch):
        with torch.inference_mode():
            compute = [layout.relayout(train_loop._local(p), mesh, s, c)
                       for p, s, c in zip(tree_flatten(params), lay.param_specs,
                                          lay.compute_specs)]
            p = tree_unflatten(params, compute)
            with activate_mesh(mesh, lay.rules):
                logits, cache = prefill(p, batch["tokens"], cfg,
                                        frontend_embeds=batch.get("frontend_embeds"))
                if vocab_split(p["embed"], cfg) is not None:
                    logits = _mask_pad_logits(C.all_gather(logits, mesh, MODEL, dim=-1), cfg)
        return logits, cache

    return run


def make_mesh_decode(cfg: ArchConfig, lay: train_loop.MeshLayout, capacity: int):
    """Returns decode(params, cache, batch) → (logits (B_l, V) f32, cache)
    for one rank of ``lay.mesh`` (``lay`` of the global batch and one token
    a row): the params relayouted to the compute layout as
    ``make_mesh_prefill`` does, ``decode_step`` on the rank's tokens, its
    block of the cache of ``capacity`` positions (``decode_cache_specs``)
    and ``batch["pos"]``, under the mesh; the logits gathered over "model"
    where the vocabulary is split (``decode_step``)."""
    mesh = lay.mesh

    def run(params, cache, batch):
        with torch.inference_mode():
            compute = [layout.relayout(train_loop._local(p), mesh, s, c)
                       for p, s, c in zip(tree_flatten(params), lay.param_specs,
                                          lay.compute_specs)]
            p = tree_unflatten(params, compute)
            with activate_mesh(mesh, lay.rules):
                return decode_step(p, cache, batch["token"], batch["pos"], cfg,
                                   capacity=capacity)

    return run


def rank_cache(cfg: ArchConfig, mesh, rules, batch: int, capacity: int) -> dict:
    """The rank's block of a zero decode cache of ``batch`` rows and
    ``capacity`` positions (``decode_cache_specs``); with ``mesh`` None,
    the whole cache."""
    if mesh is None:
        return {k: torch.zeros(d.shape, dtype=d.dtype)
                for k, d in cache_defs(cfg, batch=batch, max_len=capacity).items()}
    return {k: torch.zeros(shard_shape(d.shape, spec, mesh), dtype=d.dtype)
            for k, (d, spec) in decode_cache_specs(cfg, mesh, rules, batch, capacity).items()}


def lower_cell(cfg: ArchConfig, shape_id: str, mesh_shape, *, fsdp: bool | None = None,
               parallelism: str = "tp", batch: int | None = None, seq: int | None = None):
    """Returns (``trace.Trace``, meta) for one cell: rank 0's real step on
    fake tensors over a fake world of ``mesh_shape``'s size, its state
    built as ``Trainer._init_state`` builds it on a mesh (the params alone
    for a prefill, the params and the rank's block of the cache for a
    decode).  A train cell runs ``make_mesh_step`` once, a prefill cell
    ``make_mesh_prefill``, a decode cell ``make_mesh_decode``.
    ``mesh_shape`` None: one device and no world, ``make_train_step``,
    ``prefill`` or ``decode_step`` on the whole state.  ``batch`` and ``seq``
    replace the shape's global batch and sequence length (a decode's cache
    capacity).  Nothing falls back: a missing fake backend or a step that
    fails under fake tensors raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.trace import fake_world, trace

    kind = SHAPES[shape_id]["kind"]
    fsdp = default_fsdp(cfg) if fsdp is None else fsdp
    b = SHAPES[shape_id]["global_batch"] if batch is None else batch
    s = SHAPES[shape_id]["seq_len"] if seq is None else seq
    meta = {"kind": kind, "fsdp": fsdp}
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    if mesh_shape is None:
        with FakeTensorMode():
            params = init_model(cfg, gen(), "cpu")
            inputs = rank_batch(cfg, kind, b, s)
            if kind == "train":
                opt_state = init_opt_state(cfg.optimizer, param_defs(cfg), params)
                _, got = trace(train_loop.make_train_step(cfg), params, opt_state, inputs, 0,
                               state=(params, opt_state), inputs=inputs)
            elif kind == "decode":
                cache = rank_cache(cfg, None, None, b, s)
                _, got = trace(_decode_one, cfg, params, cache, inputs, state=(params, cache),
                               inputs=inputs)
            else:
                _, got = trace(_prefill_one, cfg, params, inputs, state=params, inputs=inputs)
        return got, meta
    rules = make_rules(parallelism, fsdp=fsdp)
    with fake_world(mesh_shape) as mesh, FakeTensorMode():
        lay = train_loop.MeshLayout(cfg, mesh, rules, b, 1 if kind == "decode" else s)
        blocks = init_model(cfg, gen(), "cpu", keep=lay.keep())
        inputs = rank_batch(cfg, kind, lay.local_batch, s)
        if kind == "decode":
            params = tree_unflatten(blocks, lay.wrap(tree_flatten(blocks), lay.param_specs))
            cache = rank_cache(cfg, mesh, rules, b, s)
            _, got = trace(make_mesh_decode(cfg, lay, s), params, cache, inputs,
                           state=(params, cache), inputs=inputs)
        elif kind == "train":
            params, opt_state = train_loop.mesh_state(lay, blocks)
            _, got = trace(train_loop.make_mesh_step(cfg, lay), params, opt_state, inputs, 0,
                           state=(params, opt_state), inputs=inputs)
        else:
            params = tree_unflatten(blocks, lay.wrap(tree_flatten(blocks), lay.param_specs))
            _, got = trace(make_mesh_prefill(cfg, lay), params, inputs, state=params,
                           inputs=inputs)
    return got, meta


def _prefill_one(cfg: ArchConfig, params, batch):
    with torch.inference_mode():
        return prefill(params, batch["tokens"], cfg, frontend_embeds=batch.get("frontend_embeds"))


def _decode_one(cfg: ArchConfig, params, cache, batch):
    with torch.inference_mode():
        return decode_step(params, cache, batch["token"], batch["pos"], cfg)


def fit_depths(cfg: ArchConfig) -> tuple[int, int]:
    """The reference's two depths of the fit: hybrid's ≡ 3 (mod
    ``attn_every``), so that the shared block's applications stay linear."""
    if cfg.family == "hybrid":
        return 9, 15
    if cfg.family == "moe" and cfg.first_k_dense:
        return cfg.first_k_dense + 2, cfg.first_k_dense + 6
    if cfg.family == "audio":
        return 2, cfg.num_layers  # decoder depth; encoder fixed in the base
    return 4, 8


def depth_fit_analysis(cfg: ArchConfig, shape_id: str, mesh_shape, fsdp: bool,
                       parallelism: str = "tp", **shape) -> dict:
    """The matmul FLOPs and the collective operand bytes by kind a device at
    ``cfg``'s depth, extrapolated from traces at the two ``fit_depths``:
    cost(L) = base + slope·L.  The port walks its layers in Python, so a
    full-depth trace counts every layer; the fit is its cross-check."""
    la, lb = fit_depths(cfg)
    lf = cfg.num_layers
    points = {}
    for L in (la, lb):
        got, _ = lower_cell(dataclasses.replace(cfg, num_layers=L), shape_id, mesh_shape,
                            fsdp=fsdp, parallelism=parallelism, **shape)
        points[L] = {
            "flops": float(got.flops),
            "coll": {k: float(v["operand_bytes"])
                     for k, v in got.collectives.summary()["by_op"].items()},
        }

    def extrap(key_a: float, key_b: float) -> float:
        slope = (key_b - key_a) / (lb - la)
        return max(key_a + slope * (lf - la), 0.0)

    pa, pb = points[la], points[lb]
    kinds = sorted(set(pa["coll"]) | set(pb["coll"]))
    coll_full = {k: extrap(pa["coll"].get(k, 0.0), pb["coll"].get(k, 0.0)) for k in kinds}
    return {
        "depths": [la, lb],
        "points": points,
        "flops_per_dev": extrap(pa["flops"], pb["flops"]),
        "coll_bytes_per_dev": sum(coll_full.values()),
        "coll_by_op": coll_full,
    }


# ---------------------------------------------------------------------------
# One full cell: layout → arithmetic → trace → JSON
# ---------------------------------------------------------------------------
def cell_arithmetic(arch: str, shape_id: str, *, multi_pod: bool = False,
                    overrides: dict[str, Any] | None = None, tag: str = "") -> dict:
    """The cell's JSON from the layouts and shapes alone: its fields that
    only a trace gives (``TRACED_FIELDS``) are ``null``."""
    overrides = dict(overrides or {})
    parallelism = overrides.pop("parallelism", "tp")
    cfg = apply_overrides(get_config(arch), overrides)
    ok, why = cfg.supports(shape_id)
    if not ok:
        return {"arch": arch, "shape": shape_id, "skipped": why}

    mesh = production_mesh_shape(multi_pod)
    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    chips = mesh.size()
    kind = SHAPES[shape_id]["kind"]
    fsdp = default_fsdp(cfg)
    rules = make_rules(parallelism, fsdp=fsdp)
    with activate_mesh(mesh, rules):
        inputs = cell_inputs(cfg, shape_id, mesh, rules)
        coll = cell_collectives(cfg, shape_id, mesh, rules)
    if parallelism == "fsdp_only":
        plan = MeshPlan(dp=chips, tp=1, fsdp=True)
    else:
        plan = MeshPlan(dp=chips // mesh.shape["model"], tp=mesh.shape["model"], fsdp=fsdp)
    resident = resident_bytes_per_device(inputs, mesh)
    roof = estimate_step(cfg, shape_id, plan)
    return {
        "arch": arch,
        "shape": shape_id,
        "mesh": mesh_name,
        "kind": kind,
        "fsdp": fsdp,
        "parallelism": parallelism,
        "chips": chips,
        "overrides": overrides or {},
        "tag": tag,
        "lower_s": None,
        "compile_s": None,
        "cost_analysis": None,
        "mem_terms": hbm_bytes_terms(cfg, shape_id, plan),
        "model_flops": model_flops_of(cfg, shape_id),
        "collectives": {"analytic": coll.summary(), "traced": None, "hlo": None},
        "resident_bytes_per_dev": resident,
        "resident_gb_per_dev": round(resident / 1024**3, 3),
        "live_bytes_per_dev": None,
        "live_gb_per_dev": None,
        "hbm_bytes": DEFAULT_CHIP.hbm_bytes,
        "fits_hbm_resident": resident <= DEFAULT_CHIP.hbm_bytes,
        "fits_hbm_live": None,
        "memory_analysis": None,
        "roofline": roof.summary(),
        "hlo_bytes": None,
    }


TRACED_FIELDS = ("lower_s", "cost_analysis", "live_bytes_per_dev", "live_gb_per_dev",
                 "fits_hbm_live", "memory_analysis")


def trace_cell(result: dict, overrides: dict[str, Any] | None = None) -> dict:
    """``result`` (``cell_arithmetic``'s) with its traced fields filled in:
    the full-depth trace's matmul FLOPs, live bytes at the peak and their
    breakdown, collectives and wall time, and the depth fit."""
    overrides = dict(overrides or {})
    parallelism = overrides.pop("parallelism", "tp")
    cfg = apply_overrides(get_config(result["arch"]), overrides)
    mesh = production_mesh_shape(result["chips"] == 512)
    got, meta = lower_cell(cfg, result["shape"], mesh, fsdp=result["fsdp"],
                           parallelism=parallelism)
    fit = depth_fit_analysis(cfg, result["shape"], mesh, meta["fsdp"], parallelism)
    coll = result["collectives"]
    return dict(
        result,
        lower_s=round(got.seconds, 2),
        cost_analysis={
            "flops_per_dev": float(got.flops),
            "flops_counted": "matrix products (torch.utils.flop_counter), not XLA's count",
            "bytes_per_dev": result["mem_terms"]["total"],
            "fit": fit,
        },
        collectives=dict(coll, traced=got.collectives.summary(), fit_by_op=fit["coll_by_op"]),
        live_bytes_per_dev=got.peak_bytes,
        live_gb_per_dev=round(got.peak_bytes / 1024**3, 3),
        fits_hbm_live=got.peak_bytes <= DEFAULT_CHIP.hbm_bytes,
        memory_analysis=got.breakdown(2000),
    )


def run_cell(
    arch: str,
    shape_id: str,
    *,
    multi_pod: bool = False,
    overrides: dict[str, Any] | None = None,
    out_dir: str | None = None,
    tag: str = "",
    verbose: bool = True,
) -> dict:
    """One cell: ``cell_arithmetic``, then ``trace_cell``, written to
    ``out_dir`` as JSON."""
    result = cell_arithmetic(arch, shape_id, multi_pod=multi_pod, overrides=overrides, tag=tag)
    if "skipped" in result:
        return result
    result = trace_cell(result, overrides)
    mesh_name = result["mesh"]
    if verbose:
        r = result["roofline"]
        traced = result["collectives"]["traced"]
        live = (f"traced {result['lower_s']:.1f}s live {result['live_gb_per_dev']:.2f} GB/dev "
                f"(fits {result['fits_hbm_live']})  flops "
                f"{result['cost_analysis']['flops_per_dev']:.4g}/dev  traced coll == analytic "
                f"{traced == result['collectives']['analytic']}")
        print(
            f"[{mesh_name}] {arch} × {shape_id}: resident {result['resident_gb_per_dev']:.2f} "
            f"GB/dev (fits {result['fits_hbm_resident']})  {live}  "
            f"T={r['t_step_s'] * 1e3:.2f} ms  bottleneck={r['bottleneck']}  mfu={r['mfu']:.3f}  "
            f"coll={result['collectives']['analytic']['total_bytes'] / 1e6:.1f} MB/dev (analytic)",
            flush=True,
        )
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fname = f"{mesh_name}__{arch}__{shape_id}{suffix}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


def iter_cells():
    for arch in list_archs():
        cfg = get_config(arch)
        for shape_id in SHAPES:
            ok, _ = cfg.supports(shape_id)
            if ok:
                yield arch, shape_id


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def table(out_dir: str) -> str:
    """A markdown table of the traced cells written to ``out_dir``, a row a
    cell, each column "16x16 / 2x16x16": live GiB a device and whether they
    fit, the traced matmul FLOPs a device, over the model FLOPs a device and
    over the step cost model's compute term, whether the traced collectives
    equal the analytic count, and the trace seconds."""
    cells: dict = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                c = json.load(f)
            if c.get("cost_analysis") is not None:
                cells.setdefault((c["arch"], c["shape"]), {})[c["mesh"]] = c

    def flops(c):
        return c["cost_analysis"]["flops_per_dev"]

    columns = (
        ("live GiB/dev", lambda c: f"{c['live_gb_per_dev']}"),
        ("fits_hbm_live", lambda c: f"{c['fits_hbm_live']}"),
        ("traced FLOPs/dev", lambda c: f"{flops(c):.4g}"),
        ("/ model_flops/dev", lambda c: f"{flops(c) * c['chips'] / c['model_flops']:.3f}"),
        ("/ estimate_step compute",
         lambda c: f"{flops(c) / (c['roofline']['compute_s'] * DEFAULT_CHIP.peak_flops):.3f}"),
        ("traced = analytic",
         lambda c: f"{c['collectives']['traced'] == c['collectives']['analytic']}"),
        ("trace s", lambda c: f"{c['lower_s']}"),
    )
    rows = ["| arch | shape | " + " | ".join(h for h, _ in columns) + " |",
            "|---|---|" + "---|" * len(columns)]
    for (arch, shape), by in sorted(cells.items()):
        ms = [by[m] for m in ("16x16", "2x16x16") if m in by]
        rows.append(f"| {arch} | {shape} | " + " | ".join(
            " / ".join(fn(c) for c in ms) for _, fn in columns) + " |")
    return "\n".join(rows)


def _parse_override(s: str) -> tuple[str, Any]:
    k, v = s.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="every supported cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--override", action="append", default=[], metavar="K=V")
    ap.add_argument("--tag", default="", help="suffix for hillclimb variants")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the table of the traced cells in --out; trace nothing")
    args = ap.parse_args(argv)

    if args.list:
        for a, s in iter_cells():
            print(a, s)
        return 0
    if args.table:
        print(table(args.out))
        return 0

    overrides = dict(_parse_override(s) for s in args.override)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    failures = []
    for multi_pod in meshes:
        for arch, shape_id in cells:
            try:
                run_cell(
                    arch, shape_id, multi_pod=multi_pod,
                    overrides=overrides, out_dir=args.out, tag=args.tag,
                )
            except Exception as e:  # one cell's failure is reported, the others still run
                failures.append((arch, shape_id, multi_pod, repr(e)))
                print(f"FAIL [{'multi' if multi_pod else 'single'}] {arch} × {shape_id}: {e!r}",
                      file=sys.stderr)
    if failures:
        print(f"\n{len(failures)} cell(s) FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
