"""Moving a tensor between layouts on a mesh (SPMD, one process a rank).

A layout is a spec (``rules.spec_for``'s: one entry a tensor dim, the mesh
axes that split it, major first).  ``block_of`` cuts this rank's block out
of a whole tensor (no communication); ``relayout`` turns this rank's block
under one spec into its block under another, all-gathering a dim over the
axes that split it in the source (innermost first, so the blocks land in
row-major order) and slicing it by the target's (a source split that leads
the target's is only sliced further); ``full_on_first`` gathers the
whole tensor to the first ranks alone; ``relayout_sends`` counts
what ``relayout`` sends, from shapes alone.  Every collective goes through
``core.collectives``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import collectives as C
from repro_torch.sharding.rules import axis_sizes, entry_axes


def _slice(x: torch.Tensor, mesh, dim: int, axes) -> torch.Tensor:
    for ax in axes:
        n = C.axis_size(mesh, ax)
        blk = x.shape[dim] // n
        x = x.narrow(dim, C.axis_index(mesh, ax) * blk, blk)
    return x


def block_of(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a view)."""
    for dim, e in enumerate(spec):
        x = _slice(x, mesh, dim, entry_axes(e))
    return x


def _moves(a: tuple, b: tuple) -> tuple[tuple, tuple]:
    """(axes to gather, axes to slice) taking a dim split over ``a`` to one
    split over ``b``: a source that leads the target is only sliced on."""
    if b[:len(a)] == a:
        return (), b[len(a):]
    return a, b


def relayout(x: torch.Tensor, mesh, src, dst) -> torch.Tensor:
    """This rank's block under ``dst`` from its block ``x`` under ``src``."""
    for dim, (a, b) in enumerate(zip(src, dst)):
        gather, cut = _moves(entry_axes(a), entry_axes(b))
        for ax in reversed(gather):
            x = C.all_gather(x, mesh, ax, dim=dim)
        x = _slice(x, mesh, dim, cut)
    return x


def full(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The whole tensor from this rank's block under ``spec``."""
    return relayout(x, mesh, spec, (None,) * len(spec))


def full_on_first(x: torch.Tensor, mesh, spec) -> torch.Tensor | None:
    """The whole tensor from this rank's block under ``spec``, gathered to
    the ranks at coordinate 0 of every axis that splits it (among them
    global rank 0), innermost axis first as ``relayout`` gathers; ``None``
    on every other rank.  The ranks of one gather's group agree on whether
    they hold a block, so a rank that holds none leaves the later gathers
    to the others."""
    for dim, e in enumerate(spec):
        for ax in reversed(entry_axes(e)):
            if x is None:
                return None
            x = C.gather_to_first(x, mesh, ax, dim=dim)
    return x


def relayout_sends(shape, dtype, mesh, src, dst, stats: C.CollectiveStats) -> None:
    """Add what ``relayout`` of a tensor of (whole) ``shape`` sends to ``stats``."""
    sizes = axis_sizes(mesh)
    block = [dim // math.prod(sizes[a] for a in entry_axes(e)) for dim, e in zip(shape, src)]
    item = torch.empty((), dtype=dtype).element_size()
    for dim, (a, b) in enumerate(zip(src, dst)):
        gather, cut = _moves(entry_axes(a), entry_axes(b))
        for ax in reversed(gather):
            if sizes[ax] > 1:
                stats.add("all-gather", math.prod(block) * item)
            block[dim] *= sizes[ax]
        block[dim] //= math.prod(sizes[ax] for ax in cut)


def first_replica(mesh, spec) -> bool:
    """Whether this rank is coordinate 0 on every axis ``spec`` leaves
    replicated: one rank of each set holding the same block."""
    used = {a for e in spec for a in entry_axes(e)}
    return all(C.axis_index(mesh, ax) == 0 for ax in axis_sizes(mesh) if ax not in used)


def spec_of_placements(placements, ndim: int, mesh) -> tuple:
    """The spec of DTensor ``placements`` (mesh order within a dim)."""
    names = list(axis_sizes(mesh))
    axes: list[list[str]] = [[] for _ in range(ndim)]
    for name, p in zip(names, placements):
        if p.is_shard():
            axes[p.dim].append(name)
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a)) for a in axes)
