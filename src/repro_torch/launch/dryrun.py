"""Multi-pod dry run: the distribution config of every cell, as arithmetic.

For every (architecture × input shape) cell and both production meshes
(single-pod 16×16, multi-pod 2×16×16) this lays out the REAL step's inputs
(the params and optimizer state of ``training.train_loop.abstract_state``,
the batch and caches of ``configs.input_specs``) by the sharding rules on
the mesh's shape, and reports per device:

  * the resident bytes of those inputs (their shard shapes) and whether they
    fit ``core.energy.H100Chip``'s 80 GB of HBM;
  * the step's model FLOPs and the step cost model's terms
    (``core.cost_model``: ``hbm_bytes_terms``, ``estimate_step``);
  * the collective bytes one step of the port sends, counted from the
    placements and shapes (``training.train_loop.step_collectives`` for a
    train cell; the weight gathers, the tensor-parallel sums and the sharded
    MoE's forward for prefill and decode: ``forward_collectives``).

The reference (``repro.launch.dryrun``) lowers and compiles each cell
through GSPMD on 512 forced host devices and reads the compiled module.  The
port has no GSPMD, no compile and no HLO, so what only a compiled module
gives is written as ``null`` in each cell's JSON: ``cost_analysis`` (HLO
FLOPs and bytes, the depth fit), ``memory_analysis`` and the live bytes,
the HLO collective bytes, and the lower and compile times.  Nothing here
starts a process group or touches a device.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes]
  python -m repro_torch.launch.dryrun --arch X --shape Y --override remat=none
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
from repro_torch.configs.base import ArchConfig
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
from repro_torch.models.model import param_defs
from repro_torch.models.params import abstract_params, tree_flatten
from repro_torch.sharding import layout
from repro_torch.sharding.rules import MeshShape, activate_mesh, make_rules, spec_for
from repro_torch.training import train_loop

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
                        decode: bool = False) -> C.CollectiveStats:
    """What a forward pass (prefill, a decode step) of the port sends from
    each rank: the weight gathers to the compute layout, the
    tensor-parallel sums of the embedding and the layers
    (``train_loop.tp_collectives``: every kind but the loss's and the MTP
    head's, which only training runs, and with ``decode`` but whisper's
    encoder's: a decode step reads the cross K/V its prompt's prefill
    left), the last position's logits (f32)
    gathered over "model" where the vocabulary is split, and each MoE
    layer's forward on the rank's tokens."""
    lay = train_loop.MeshLayout(cfg, mesh, rules, batch, seq)
    stats = C.CollectiveStats()
    if mesh.size() == 1:
        return stats
    for d, s, c in zip(lay.param_defs, lay.param_specs, lay.compute_specs):
        layout.relayout_sends(d.shape, d.dtype, mesh, s, c, stats)
    tp = train_loop.tp_collectives(lay, lay.local_batch, seq, cfg.dtype)
    for what, nbytes, count, _ in tp:
        if what in ("layer", "norm", "shared", "embed") or (what == "encoder" and not decode):
            stats.add("all-reduce", nbytes, count)
    if any(what == "loss" for what, *_ in tp):  # the vocabulary is split
        stats.add("all-gather", 4 * lay.local_batch * cfg.padded_vocab // mesh.shape["model"])
    if cfg.moe is not None:
        fwd = moe.moe_collectives(cfg, mesh, lay.local_batch, seq, cfg.dtype)
        for k in fwd.counts:
            stats.add(k, fwd.operand_bytes[k] // fwd.counts[k],
                      fwd.counts[k] * (cfg.num_layers - cfg.first_k_dense))
    return stats


def cell_collectives(cfg: ArchConfig, shape_id: str, mesh, rules) -> C.CollectiveStats:
    sh = SHAPES[shape_id]
    b, s = sh["global_batch"], sh["seq_len"]
    if sh["kind"] == "train":
        return train_loop.step_collectives(cfg, mesh, rules, b, s)
    if sh["kind"] == "prefill":
        return forward_collectives(cfg, mesh, rules, b, s)
    return forward_collectives(cfg, mesh, rules, b, 1, decode=True)


# ---------------------------------------------------------------------------
# One full cell: layout → arithmetic → JSON
# ---------------------------------------------------------------------------
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
    result = {
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
        "collectives": {"analytic": coll.summary(), "hlo": None},
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
    if verbose:
        r = result["roofline"]
        print(
            f"[{mesh_name}] {arch} × {shape_id}: resident {result['resident_gb_per_dev']:.2f} "
            f"GB/dev (fits {result['fits_hbm_resident']})  T={r['t_step_s'] * 1e3:.2f} ms  "
            f"bottleneck={r['bottleneck']}  mfu={r['mfu']:.3f}  "
            f"coll={coll.total_bytes / 1e6:.1f} MB/dev (port, analytic)"
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
    args = ap.parse_args(argv)

    if args.list:
        for a, s in iter_cells():
            print(a, s)
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
