"""Parameter definition machinery.

Every model module declares its parameters once as a tree of ``ParamDef``
(shape + logical axis names + initializer): dicts, lists and tuples with
``ParamDef`` leaves.  From that declaration come real initialization
(:func:`init_params`, from an explicit ``torch.Generator``) and parameter
counts.  :func:`params_from_numpy` carries a tree of numpy arrays, such as
the JAX package's parameters, into tensors on a device.

The sharding-side derivations of the reference (abstract parameter trees,
partition specs) are not ported yet.
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


def _initialize(gen: torch.Generator, d: ParamDef) -> torch.Tensor:
    def normal():
        return torch.randn(d.shape, generator=gen, dtype=torch.float32, device=gen.device)

    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype)
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
    return tree_map(lambda d: _initialize(generator, d).to(dev), defs)


def params_from_numpy(tree: Pytree, device=None) -> Pytree:
    """Carry a tree of numpy arrays (the JAX package's parameters, handed
    over with ``np.asarray``) into the port: same structure and types,
    tensors on ``device`` (``None`` means the card).  The arrays are copied,
    so the two sides never share memory."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def count_params(defs: Pytree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def stacked(n: int, defs: Pytree) -> Pytree:
    """Prepend a scan ('layers') dimension to every ParamDef in a subtree."""

    def add(d: ParamDef) -> ParamDef:
        return dataclasses.replace(d, shape=(n, *d.shape), logical=("layers", *d.logical))

    return tree_map(add, defs)
