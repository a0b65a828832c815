"""Moving a tensor between layouts on a mesh (SPMD, one process a rank).

A layout is a spec (``rules.spec_for``'s: one entry a tensor dim, the mesh
axes that split it, major first).  ``block_of`` cuts this rank's block out
of a whole tensor (no communication); ``relayout`` turns this rank's block
under one spec into its block under another, all-gathering a dim over the
axes that split it in the source (innermost first, so the blocks land in
row-major order) and slicing it by the target's (a source split that leads
the target's is only sliced further), every gather ahead of every slice;
an axis that leaves one dim for another moves by one all-to-all
(``_plan``); ``full_on_first`` gathers the
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


def _plan(src, dst) -> tuple[list, list]:
    """How ``relayout`` takes a block under ``src`` to one under ``dst``:
    the moves in order, each ``("gather", axis, dim)`` (an all-gather along
    ``dim``) or ``("a2a", axis, dim, to)`` (an all-to-all over ``axis`` that
    concatenates ``dim`` and splits ``to``), then the cuts ``[(dim, axes)]``
    (slices, major axis first).  A dim keeps the leading axes its source
    and target share and gathers the rest of its source's, innermost
    first; where the axis it gathers is the next one another dim is cut
    by, and that dim is gathered no further, one all-to-all does both (a
    block moves between ranks, no rank holds more than its block: an
    expert leaf's fsdp split over "data" moving onto its expert dim)."""
    cur = [list(entry_axes(e)) for e in src]
    want = [entry_axes(e) for e in dst]

    def prefix(i):
        return tuple(cur[i]) == want[i][:len(cur[i])]

    moves = []
    for i in range(len(cur)):
        while not prefix(i):
            ax = cur[i].pop()
            to = next((j for j in range(len(cur)) if j != i and prefix(j)
                       and want[j][len(cur[j]):len(cur[j]) + 1] == (ax,)), None)
            if to is None:
                moves.append(("gather", ax, i))
            else:
                moves.append(("a2a", ax, i, to))
                cur[to].append(ax)
    return moves, [(i, want[i][len(cur[i]):]) for i in range(len(cur))]


def relayout(x: torch.Tensor, mesh, src, dst) -> torch.Tensor:
    """This rank's block under ``dst`` from its block ``x`` under ``src``
    (``_plan``'s moves); a block cut out of a gathered tensor is a copy,
    so that the gathered tensor is freed."""
    moves, cuts = _plan(src, dst)
    for move in moves:
        if move[0] == "gather":
            x = C.all_gather(x, mesh, move[1], dim=move[2])
        else:
            x = C.all_to_all(x, mesh, move[1], split_dim=move[3], concat_dim=move[2])
    for dim, axes in cuts:
        x = _slice(x, mesh, dim, axes)
    if moves and any(axes for _, axes in cuts):
        x = x.contiguous()
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
    for move in _plan(src, dst)[0]:
        ax, dim = move[1], move[2]
        if sizes[ax] > 1:
            stats.add("all-gather" if move[0] == "gather" else "all-to-all",
                      math.prod(block) * item)
        block[dim] *= sizes[ax]
        if move[0] == "a2a":
            block[move[3]] //= sizes[ax]


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
