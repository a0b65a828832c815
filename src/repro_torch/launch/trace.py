"""A rank's step run on fake tensors over a fake world: what it computes,
holds and sends, with nothing allocated and no device touched.

``fake_world(mesh_shape)`` starts torch's fake process group
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once, nothing is sent) with as many ranks as the mesh has, and yields a
``DeviceMesh`` of the production axis names on ``"cpu"``; this process is
rank 0.  The group is destroyed on the way out, whatever happens.  The
process group is global: a world cannot start while another is open.

``trace(fn, *args, state=..., inputs=...)`` runs ``fn(*args)`` once (under
``FakeTensorMode``, which the caller opens and built ``args`` under) and
reads, in that one run:

  * the FLOPs of its matrix products (``torch.utils.flop_counter``'s count:
    mm, bmm, addmm, convolutions, attention), not the elementwise FLOPs that
    XLA's ``cost_analysis`` adds;
  * the collectives it sent (``core.collectives.recording``), by kind;
  * the live bytes at their peak (``LiveBytes``): the tensors' storages from
    the moment an operation makes one to the moment the last reference to
    it goes, the ``state`` and the ``inputs`` counted from the start; the
    peak's breakdown by what made each storage (the state, the inputs, or
    the aten operation);
  * its wall time on the host.

Every piece raises where it is missing or fails: there is no fallback.
The figures are a trace of the port's code, not times or bytes on a card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import collectives as C
from repro_torch.sharding.rules import axis_sizes


@contextlib.contextmanager
def fake_world(mesh_shape):
    """A ``DeviceMesh`` of ``mesh_shape``'s axes over a fake process group of
    its size, this process rank 0; the group destroyed on the way out."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already started: the fake world needs its own")
    sizes = axis_sizes(mesh_shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(sizes.values()))
    try:
        yield init_device_mesh("cpu", tuple(sizes.values()), mesh_dim_names=tuple(sizes))
    finally:
        dist.destroy_process_group()


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive, and their peak, over the operations
    run under it.  A storage counts from the operation that made it (or
    from ``track``) until its last reference goes; a view or an in-place
    result is its base's storage and counts once.  ``peak_by`` is the peak's
    breakdown by what made each storage."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.by: dict[str, int] = {}
        self.peak_by: dict[str, int] = {}
        self._refs: dict[int, weakref.ref] = {}

    def _add(self, t: torch.Tensor, what: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        ref = self._refs.get(key)
        if ref is not None and ref() is st:
            return
        nbytes = st.nbytes()
        self._refs[key] = weakref.ref(st, lambda _, k=key, n=nbytes, w=what: self._free(k, n, w))
        self.live += nbytes
        self.by[what] = self.by.get(what, 0) + nbytes

    def _free(self, key: int, nbytes: int, what: str) -> None:
        self._refs.pop(key, None)
        self.live -= nbytes
        self.by[what] -= nbytes

    def _mark(self) -> None:
        if self.live > self.peak:
            self.peak = self.live
            self.peak_by = {k: v for k, v in self.by.items() if v}

    def track(self, tensors, what: str) -> None:
        """Count ``tensors`` (DTensors by their local shards) as ``what`` from now."""
        for t in tree_leaves(tensors):
            if isinstance(t, torch.Tensor):
                self._add(getattr(t, "_local_tensor", t), what)
        self._mark()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t, name)
        self._mark()
        return out


@dataclasses.dataclass
class Trace:
    """What one traced run computed (matmul FLOPs), sent and held."""

    flops: int
    collectives: C.CollectiveStats
    peak_bytes: int
    peak_by: dict
    seconds: float

    def breakdown(self, limit: int = 2000) -> str:
        """The peak's breakdown, largest first, at most ``limit`` characters."""
        parts = [f"{k}: {v}" for k, v in sorted(self.peak_by.items(), key=lambda kv: -kv[1])]
        return (f"peak {self.peak_bytes} B = " + ", ".join(parts))[:limit]


def trace(fn, *args, state=(), inputs=()) -> tuple:
    """(``fn(*args)``, its ``Trace``), ``state`` and ``inputs`` live from the start."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    mem = LiveBytes()
    t0 = time.perf_counter()
    with C.recording() as sent, flops, mem:
        mem.track(state, "state")
        mem.track(inputs, "inputs")
        out = fn(*args)
    seconds = time.perf_counter() - t0
    return out, Trace(flops.get_total_flops(), sent, mem.peak, mem.peak_by, seconds)
