"""Parameter definition machinery.

Every model module declares its parameters once as a tree of ``ParamDef``
(shape + logical axis names + initializer): dicts, lists and tuples with
``ParamDef`` leaves.  From that declaration come real initialization
(:func:`init_params`, from an explicit ``torch.Generator``) and parameter
counts.  :func:`params_from_numpy` carries a tree of numpy arrays, such as
the JAX package's parameters, into tensors on a device: bfloat16 arrays bit
for bit, and quantized weights (a pair with fields ``q`` and ``scale``) as
the port's ``models.quant.QuantTensor``.  :func:`abstract_params` gives
the tree's shapes, dtypes and specs with nothing allocated, and
:func:`param_specs` its specs (``sharding.rules``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declaration of a single parameter tensor."""

    shape: tuple[int, ...]
    logical: tuple[str | None, ...]  # one logical axis name per dim
    init: str = "fan_in"  # fan_in | zeros | ones | normal | embed | scalar_log
    dtype: torch.dtype = torch.bfloat16
    scale: float = 1.0  # extra multiplier for normal init

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes {self.logical} differ in rank")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn: Callable[[Any], Any], tree: Pytree) -> Pytree:
    """Apply ``fn`` to every leaf of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Pytree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _is_node(tree) -> bool:
    return isinstance(tree, dict) or (isinstance(tree, (list, tuple))
                                      and not hasattr(tree, "_fields"))


def tree_flatten(tree: Pytree) -> list:
    """The leaves in the JAX package's order (``jax.tree_util.tree_flatten``:
    dict keys sorted, lists and tuples in order), which fixes a checkpoint's
    leaf files and an optimizer's walk over several trees of one structure."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if _is_node(tree):
        return [leaf for v in tree for leaf in tree_flatten(v)]
    return [tree]


def tree_unflatten(like: Pytree, leaves: list) -> Pytree:
    """``like``'s structure with ``leaves`` (in ``tree_flatten``'s order) in
    place of its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):  # leaves taken in sorted key order, keys kept in t's
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_node(t):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_structure(tree: Pytree) -> str:
    """The tree's shape as the JAX package prints a treedef's structure:
    ``{'a': *, 'b': [*, *]}``, dict keys sorted."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(tree_structure(v) for v in tree) + "]"
    if _is_node(tree):
        return "(" + ", ".join(tree_structure(v) for v in tree) + (",)" if len(tree) == 1 else ")")
    return "*"


def _initialize(gen: torch.Generator, d: ParamDef, device: torch.device) -> torch.Tensor:
    def normal():
        return torch.randn(d.shape, generator=gen, dtype=torch.float32, device=gen.device)

    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "scalar_log":  # e.g. Mamba A_log, init in [1, 16)
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32, device=gen.device)
        return torch.log(1.0 + 15.0 * u).to(d.dtype)
    if d.init == "embed":
        return (normal() * d.scale).to(d.dtype)
    if d.init == "normal":
        return (normal() * 0.02 * d.scale).to(d.dtype)
    # fan_in: std = 1/sqrt(fan_in), fan_in = first dim
    fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[0], 1)
    if len(d.shape) >= 3:  # stacked-over-layers leading dim is not fan-in
        fan_in = d.shape[-2]
    std = d.scale / math.sqrt(max(fan_in, 1))
    return (normal() * std).to(d.dtype)


def init_params(defs: Pytree, generator: torch.Generator, device=None) -> Pytree:
    """Materialize a ParamDef tree into real tensors on ``device`` (``None``
    means the card).  Numbers are drawn from ``generator`` in tree order, so
    a seed fixes them; they are NOT the JAX package's numbers for the same
    seed (carry those over with :func:`params_from_numpy`)."""
    dev = resolve_device(device)
    return tree_map(lambda d: _initialize(generator, d, dev).to(dev), defs)


def _tensor_from_numpy(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch cannot read it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_numpy(tree: Pytree, device=None) -> Pytree:
    """Carry a tree of numpy arrays (the JAX package's parameters, handed
    over with ``np.asarray``) into the port: same structure and types,
    tensors on ``device`` (``None`` means the card).  The arrays are copied,
    so the two sides never share memory.  bfloat16 arrays arrive bit for
    bit; a leaf with fields ``q`` and ``scale`` (the JAX package's
    ``QuantTensor``) becomes the port's ``QuantTensor`` of both."""
    from repro_torch.models.quant import QuantTensor

    dev = resolve_device(device)

    def leaf(a):
        if getattr(a, "_fields", None) == ("q", "scale"):
            return QuantTensor(_tensor_from_numpy(a.q, dev), _tensor_from_numpy(a.scale, dev))
        return _tensor_from_numpy(a, dev)

    return tree_map(leaf, tree)


@dataclasses.dataclass(frozen=True)
class AbstractLeaf:
    """A tensor's shape, dtype and spec (one entry a dim, as
    ``sharding.rules.spec_for`` gives; ``None`` unsharded), with no storage:
    the port's ``jax.ShapeDtypeStruct`` with a sharding."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: tuple | None = None

    def shard_shape(self, mesh) -> tuple[int, ...]:
        """The block each rank of ``mesh`` holds (``mesh``: a ``DeviceMesh`` or
        a ``sharding.rules.MeshShape``)."""
        if self.spec is None:
            return tuple(self.shape)
        from repro_torch.sharding.rules import shard_shape

        return shard_shape(self.shape, self.spec, mesh)


def abstract_params(defs: Pytree, spec_fn: Callable[[ParamDef], Any] | None = None) -> Pytree:
    """``AbstractLeaf`` tree (with ``spec_fn(d)``'s spec when given) — zero
    allocation."""
    return tree_map(lambda d: AbstractLeaf(tuple(d.shape), d.dtype,
                                           None if spec_fn is None else spec_fn(d)), defs)


def param_specs(defs: Pytree, spec_fn: Callable[[ParamDef], Any]) -> Pytree:
    """Spec tree matching the ParamDef tree."""
    return tree_map(spec_fn, defs)


def count_params(defs: Pytree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def stacked(n: int, defs: Pytree) -> Pytree:
    """Prepend a scan ('layers') dimension to every ParamDef in a subtree."""

    def add(d: ParamDef) -> ParamDef:
        return dataclasses.replace(d, shape=(n, *d.shape), logical=("layers", *d.logical))

    return tree_map(add, defs)
