"""Logical-axis → mesh-axis sharding rules (DP / FSDP / TP / EP / SP).

A rule maps a *logical* tensor axis (declared in ``ParamDef.logical``) onto
zero or more mesh axes.  ``spec_for`` additionally drops any assignment that
does not divide the dimension evenly — e.g. kv_heads=4 cannot shard over a
16-way "model" axis and falls back to replication.  The reference's
(``repro.sharding.rules``) arithmetic, one for one.

A spec is a tuple with one entry a tensor dim, as the reference's
``PartitionSpec``: a mesh-axis name, a tuple of names (the dim split over
several axes, the first major), or ``None``.  ``placements_for`` turns it
into DTensor placements, one a mesh dim: ``Shard(dim)`` on each mesh axis
the spec assigns to ``dim``, ``Replicate()`` elsewhere.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
or, for the pure arithmetic (specs, shard shapes, the dry run), anything
whose ``shape`` maps axis names to sizes (``MeshShape``).

Not ported: ``constrain``, GSPMD's layout hint for activations: the port
runs SPMD, and its layers compute on the shards they are given
(``models/layers.py``: the step's compute layout keeps the "model" split,
``training.train_loop.MeshLayout``), which is what the hint asks of GSPMD;
and ``sharding/compat.py``, a shim between JAX versions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.models.params import ParamDef

# Mesh axis names used across the framework.
POD, DATA, MODEL = "pod", "data", "model"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's shape alone, {axis name: size} in mesh order: what the rules,
    the abstract state and the dry run read, with no process group."""

    shape: Mapping[str, int]

    def size(self) -> int:
        return math.prod(self.shape.values())


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size}, in mesh order, of a ``DeviceMesh`` or a ``MeshShape``."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims have no names")
    return dict(zip(names, shape))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Assignment of logical axes to mesh axes.

    ``fsdp`` additionally shards the designated weight axis ("embed") over
    the data axis (ZeRO-3 style).  ``dp_axes`` is the batch-sharding axis
    set — ("pod","data") under the default TP mapping, ("pod","data","model")
    under fsdp_only (the same physical mesh with the model axis re-purposed
    as extra DP).
    """

    rules: Mapping[str, tuple[str, ...]]
    fsdp: bool = False
    dp_axes: tuple[str, ...] = (POD, DATA)

    def axes_for(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        got = self.rules.get(logical, ())
        if logical == "embed" and not self.fsdp:
            return ()
        return got


def tensor_parallel_rules(fsdp: bool = False) -> ShardingRules:
    """Default production rules: TP over "model", optional FSDP over "data".

    - vocab / mlp / heads / experts → "model"   (TP / EP)
    - embed → "data" when fsdp                    (ZeRO-3 weight shard)
    - layers (the stacked dim) → never sharded
    """
    return ShardingRules(
        rules={
            "vocab": (MODEL,),
            "mlp": (MODEL,),
            "heads": (MODEL,),
            "kv_heads": (MODEL,),
            "experts": (MODEL,),
            "embed": (DATA,),
            "ssm_heads": (MODEL,),
            "inner": (MODEL,),  # mamba d_inner
            "kv_seq": (MODEL,),  # decode caches: flash-decoding sequence shard
        },
        fsdp=fsdp,
    )


def fsdp_only_rules() -> ShardingRules:
    """Pure-FSDP mapping: no tensor parallelism — weights ZeRO-3-shard over
    ("data","model") jointly, the batch over the whole mesh."""
    return ShardingRules(
        rules={
            "embed": (DATA, MODEL),
            "experts": (MODEL,),  # EP stays (expert weights are per-expert)
            "kv_seq": (MODEL,),
        },
        fsdp=True,
        dp_axes=(POD, DATA, MODEL),
    )


def make_rules(parallelism: str = "tp", fsdp: bool = False) -> ShardingRules:
    if parallelism == "tp":
        return tensor_parallel_rules(fsdp=fsdp)
    if parallelism == "fsdp_only":
        return fsdp_only_rules()
    raise ValueError(parallelism)


def _dim_divides(dim: int, mesh, axes: Sequence[str]) -> bool:
    sizes = axis_sizes(mesh)
    size = 1
    for a in axes:
        if a not in sizes:
            return False
        size *= sizes[a]
    return size > 0 and dim % size == 0


def spec_for(d: ParamDef, mesh, rules: ShardingRules) -> tuple:
    """The spec of one ParamDef under ``rules``, divisibility-checked."""
    entries: list = []
    used: set[str] = set()
    for dim, logical in zip(d.shape, d.logical):
        axes = tuple(a for a in rules.axes_for(logical) if a not in used)
        if axes and _dim_divides(dim, mesh, axes):
            entries.append(axes[0] if len(axes) == 1 else axes)
            used.update(axes)
        else:
            entries.append(None)
    return tuple(entries)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple[int, ...]:
    """The per-rank block of a tensor of ``shape`` laid out by ``spec``."""
    sizes = axis_sizes(mesh)
    return tuple(dim // math.prod(sizes[a] for a in entry_axes(e))
                 for dim, e in zip(shape, spec))


def spec_placements(spec: Sequence, mesh) -> list:
    """DTensor placements of ``spec``: ``Shard(dim)`` on each mesh axis that
    splits ``dim``, ``Replicate()`` on the others.  DTensor splits a dim
    sharded over several mesh dims in mesh order, so a spec entry that names
    them in another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for dim, e in enumerate(spec):
        axes = entry_axes(e)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {e!r} is not in mesh order {names}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return out


def placements_for(d: ParamDef, mesh, rules: ShardingRules) -> list:
    """DTensor placements of one ParamDef under ``rules`` (``spec_for``'s)."""
    return spec_placements(spec_for(d, mesh, rules), mesh)


def batch_axes(mesh, rules: "ShardingRules | None" = None) -> tuple[str, ...]:
    """Data-parallel mesh axes under the active (or given) rule set."""
    rules = rules or active_rules()
    sizes = axis_sizes(mesh)
    return tuple(a for a in rules.dp_axes if a in sizes)


def batch_spec(batch_size: int, mesh, *, extra_dims: int = 1,
               rules: "ShardingRules | None" = None) -> tuple:
    """Spec for activations/batches: shard batch dim over DP axes if it divides."""
    axes = batch_axes(mesh, rules)
    sizes = axis_sizes(mesh)
    size = math.prod(sizes[a] for a in axes)
    if axes and batch_size % size == 0:
        first = axes if len(axes) > 1 else axes[0]
        return (first, *([None] * extra_dims))
    return tuple([None] * (1 + extra_dims))


# ---------------------------------------------------------------------------
# The active mesh: model code (``moe_apply``) reads it, as in the reference.
# One stack for the process, entered and left by ``activate_mesh``.
# ---------------------------------------------------------------------------
_ACTIVE: list = []


@contextlib.contextmanager
def activate_mesh(mesh, rules: "ShardingRules | None" = None):
    _ACTIVE.append((mesh, rules or tensor_parallel_rules()))
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    return _ACTIVE[-1][0] if _ACTIVE else None


def active_rules() -> ShardingRules:
    return _ACTIVE[-1][1] if _ACTIVE else tensor_parallel_rules()
