"""The port's collectives: one choke point, and a record of what they send.

Every collective of the port (the sharded MoE's all-to-alls, all-gathers
and sums, the Trainer's weight gathers and gradient means, the int8
gradient all-reduce) goes through the functions here, over one named axis
of a ``DeviceMesh`` (``mesh.get_group(axis)``).  Each adds to every open
``recording()``: the count and operand bytes by kind, in the reference's
``CollectiveStats`` (``repro.core.hlo``).  The reference reads those bytes
from HLO result shapes with these conventions: all-gather operand =
result / n, reduce-scatter operand = result × n, all-reduce and all-to-all
operand = result (``operand_bytes``).  Here every collective's operand is
its local input, whose bytes are exactly those.  The port makes no HLO, so
the reference's HLO text parser has no counterpart; what a step sends is
recorded here as it runs, or counted beforehand from placements and shapes
(``moe.moe_collectives``, ``train_loop.step_collectives``).

The tiled forms follow ``jax.lax`` with ``tiled=True``: an all-gather
concatenates the ranks' blocks along ``dim`` in rank order, an all-to-all
splits ``split_dim`` into one block a rank and concatenates the blocks it
receives along ``concat_dim``, source rank major.  ``all_gather``,
``all_reduce`` and ``all_to_all`` carry gradients: each one's backward is
its transpose (a reduce-scatter, an all-reduce, the reverse all-to-all), the
gradient of the sum of every rank's loss.

Tensor-parallel layers (``models/layers.py``: GQA over local heads, the MLP
over local columns, the vocab-parallel embedding and loss) use two
operators in Megatron's terms.  *Reduce-from-TP-region* is ``all_reduce``
over "model": the sum of the ranks' partial outputs forward, and backward
its transpose, the all-reduce of the cotangents.  *Copy-to-TP-region*, where
a replicated activation enters the split weights, is the identity both
ways, and no function.  That is the port's convention: every rank's
backward starts from its own loss, and a step differentiates the sum of the
ranks' losses, each rank's copy of a replicated tensor a variable of its
own.  Megatron's copy instead all-reduces the cotangent and its reduce
passes it through; that is the convention of one loss, where the ranks of
a tensor-parallel group hold one cotangent.  Both give the same step; the
port keeps its own because the expert-parallel MoE's collectives (an
all-gather over "model" whose transpose is a reduce-scatter, the
all-to-alls, the aux loss's sum) are transposes under it.  So a split
leaf's gradient carries the "model" ranks' n copies of the loss, as a
replicated leaf's does once summed over "model", and the step divides
every gradient by the mesh size (``train_loop.MeshLayout.reduce_grad``).
``all_reduce_max`` (no gradient) is the vocab-parallel loss's shift.

Gloo has no CUDA path for some collectives, so over a gloo group a CUDA
tensor is staged through host memory here, and only here (a copy to the
host, the collective there, a copy back); such collectives are counted in
``CollectiveStats.staged`` as well.  A mesh axis
of size 1 sends nothing and records nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

KINDS = ("all-gather", "all-reduce", "all-to-all", "reduce-scatter", "gather")


def operand_bytes(kind: str, result_bytes: int, group_size: int) -> int:
    """A collective's operand bytes from its result's, the reference's HLO
    conventions; a gather to one rank (the checkpoint save's, which HLO
    does not have) counts as an all-gather does."""
    if kind in ("all-gather", "gather"):
        return result_bytes // max(group_size, 1)
    if kind == "reduce-scatter":
        return result_bytes * group_size
    if kind in KINDS:
        return result_bytes
    raise ValueError(kind)


@dataclasses.dataclass
class CollectiveStats:
    counts: dict = dataclasses.field(default_factory=dict)
    operand_bytes: dict = dataclasses.field(default_factory=dict)
    staged: dict = dataclasses.field(default_factory=dict)  # kind → staged through the host

    @property
    def total_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    def add(self, kind: str, nbytes: int, count: int = 1) -> None:
        if kind not in KINDS:
            raise ValueError(kind)
        self.counts[kind] = self.counts.get(kind, 0) + count
        self.operand_bytes[kind] = self.operand_bytes.get(kind, 0) + nbytes * count

    def merge(self, other: "CollectiveStats", times: int = 1) -> None:
        """Adds ``other``'s counts and bytes ``times`` over (its collectives
        of one kind may differ in size)."""
        for kind, count in other.counts.items():
            self.counts[kind] = self.counts.get(kind, 0) + count * times
            self.operand_bytes[kind] = (self.operand_bytes.get(kind, 0)
                                        + other.operand_bytes[kind] * times)

    def summary(self) -> dict:
        out = {
            "total_bytes": self.total_bytes,
            "by_op": {
                k: {"count": self.counts[k], "operand_bytes": self.operand_bytes[k]}
                for k in sorted(self.counts)
            },
        }
        if self.staged:
            out["staged"] = dict(sorted(self.staged.items()))
        return out


_RECORDS: list[CollectiveStats] = []


@contextlib.contextmanager
def recording():
    """Yields a ``CollectiveStats`` that every collective in the block adds to."""
    stats = CollectiveStats()
    _RECORDS.append(stats)
    try:
        yield stats
    finally:
        _RECORDS.remove(stats)


# ---------------------------------------------------------------------------
# The choke point
# ---------------------------------------------------------------------------
def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _run(kind: str, mesh, axis: str, x: torch.Tensor, op):
    """``op(x, group, n)`` over ``axis``'s group, recorded; a CUDA tensor
    over a gloo group goes through host memory."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    for stats in _RECORDS:
        stats.add(kind, _nbytes(x))
        if staged:
            stats.staged[kind] = stats.staged.get(kind, 0) + 1
    if not staged:
        return op(x.contiguous(), group, n)
    out = op(x.cpu().contiguous(), group, n)
    return None if out is None else out.to(x.device)


def _gather0(x, group, n):
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)


def _gather_first0(x, group, n):
    first = dist.get_global_rank(group, 0)
    if dist.get_rank() != first:
        dist.gather(x, None, dst=first, group=group)
        return None
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.gather(x, parts, dst=first, group=group)
    return torch.cat(parts, dim=0)


def _scatter0(x, group, n):
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter(out, [c.contiguous() for c in x.chunk(n, dim=0)], group=group)
    return out


def _sum(x, group, n):
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def _max(x, group, n):
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def _exchange0(x, group, n):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _gather(x, mesh, axis, dim):
    if axis_size(mesh, axis) == 1:
        return x
    out = _run("all-gather", mesh, axis, x.movedim(dim, 0), _gather0)
    return out.movedim(0, dim).contiguous()  # a view no longer: np.save of a view is slow


def _scatter(x, mesh, axis, dim):
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of dim {dim} ({x.shape[dim]}) over {n} ranks")
    return _run("reduce-scatter", mesh, axis, x.movedim(dim, 0), _scatter0).movedim(
        0, dim).contiguous()


def _reduce(x, mesh, axis):
    if axis_size(mesh, axis) == 1:
        return x
    return _run("all-reduce", mesh, axis, x, _sum)


def _exchange(x, mesh, axis, split_dim, concat_dim):
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all-to-all split of dim {split_dim} ({x.shape[split_dim]}) over {n}")
    blocks = torch.stack(x.chunk(n, dim=split_dim))  # (n, ...): block j goes to rank j
    got = _run("all-to-all", mesh, axis, blocks, _exchange0)
    return torch.cat(got.unbind(0), dim=concat_dim)  # source rank major


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, *ctx.args), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)
        return _exchange(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args), None, None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks along ``dim``, concatenated in rank order."""
    return _AllGather.apply(x, mesh, axis, dim)


def all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over ``axes`` (a name or a tuple of names), one all-reduce an axis."""
    for axis in (axes,) if isinstance(axes, str) else axes:
        x = _AllReduce.apply(x, mesh, axis)
    return x


def all_reduce_max(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum over ``axis`` (no gradient)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _run("all-reduce", mesh, axis, x.detach(), _max)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's block (along ``dim``) of the sum over ``axis`` (no gradient)."""
    return _scatter(x, mesh, axis, dim)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def gather_to_first(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor | None:
    """On the rank at coordinate 0 of ``axis``, the ranks' blocks along
    ``dim`` concatenated in rank order; ``None`` on the others (no
    gradient): what a checkpoint save needs, without every rank receiving
    every block."""
    if axis_size(mesh, axis) == 1:
        return x
    out = _run("gather", mesh, axis, x.movedim(dim, 0), _gather_first0)
    return None if out is None else out.movedim(0, dim).contiguous()


def all_gather_stacked(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` on a new leading axis (no gradient)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x[None]
    return _run("all-gather", mesh, axis, x[None], _gather0)
