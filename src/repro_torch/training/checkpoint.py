"""Async checkpointing in the reference's on-disk format.

Format: one directory per step (``repro.training.checkpoint``'s) —

  step_000123/
    manifest.json    tree structure, shapes, dtypes, step, metadata
    leaf_00000.npy   flattened leaves in manifest order (np.save)
    ...
    COMMITTED        written LAST — a checkpoint without it is torn and ignored

Leaves are flattened in the JAX package's order (dict keys sorted), so a
checkpoint written by either package restores into the other.  A bfloat16
leaf is written as its uint16 bits under the manifest dtype ``"bfloat16"``
(numpy has no bfloat16); the reference's own bfloat16 files load as 2-byte
void records, and both are read back as those bits.  The manifest holds
logical shapes only, so a checkpoint restores onto any device.  Saves run on
a background thread (``wait()`` joins) from a host snapshot taken at
``save``; the COMMITTED sentinel makes a crash during a save safe.

On a mesh (SPMD, one process a rank): a tree that holds DTensors is saved
whole — each leaf is gathered from its shards to rank 0
(``sharding.layout.full_on_first``, every rank joining), rank 0 alone keeps
the snapshot and writes it (a blocking save writes one leaf while the next
is gathered), and the other ranks' ``wait()`` returns once the step's
COMMITTED marker exists.
``restore(sharding_fn=)`` gives leaf ``i`` as a DTensor laid out by
``sharding_fn(i, array) -> (mesh, placements)``, each rank holding only its
shard, so a checkpoint written on one mesh, or on one device, restores onto
another (elastic restore).
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.params import tree_flatten, tree_structure, tree_unflatten
from repro_torch.sharding.layout import block_of, full_on_first, spec_of_placements

COMMITTED = "COMMITTED"
COMMIT_TIMEOUT_S = 600.0  # on a mesh, how long a rank other than 0 waits for rank 0's commit
_BF16 = "bfloat16"


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A numpy array of ``t``'s snapshot (already a CPU tensor of its own)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return _BF16 if t.dtype == torch.bfloat16 else str(t.numpy().dtype)


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:  # uint16 bits (the port's files) or 2-byte voids (the reference's)
        return torch.from_numpy(np.asarray(a, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, dtype=np.dtype(dtype), order="C"))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _sharded(t: torch.Tensor, mesh, placements) -> DTensor:
    """This rank's block of ``t`` (a view of the mapped file) copied to the
    mesh's device, as a DTensor laid out by ``placements``."""
    spec = spec_of_placements(placements, t.dim(), mesh)
    local = block_of(t, mesh, spec).to(_mesh_device(mesh), copy=True)
    return DTensor.from_local(local, mesh, placements, run_check=False)


def _gathered(leaves, keep: bool):
    """Each leaf whole on the host, one at a time (``None`` where not
    ``keep``); a DTensor is gathered from its shards to rank 0, every rank
    joining.  Over gloo the shards are gathered on the host, where the
    snapshot goes."""
    for t in leaves:
        t = t.detach()
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            spec = spec_of_placements(t.placements, t.dim(), mesh)
            local = t.to_local()
            if dist.get_backend(mesh.get_group(0)) == "gloo":
                local = local.cpu()
            t = full_on_first(local, mesh, spec)
        yield t.to("cpu", copy=True) if keep else None


def _written_behind(write: Callable, leaves) -> None:
    """``write(leaves)`` on a thread while this one makes ``leaves`` (the
    collectives stay on the caller's thread): one leaf written while the
    next is gathered, at most two on the host besides.  If making them
    fails, the writer stops before its commit."""
    q: queue.Queue = queue.Queue(maxsize=1)
    done, abort = object(), object()
    failed: list = []

    ended: list = []

    def items():
        while True:
            t = q.get()
            if t is done or t is abort:
                ended.append(t)
                if t is abort:
                    raise RuntimeError("the save's gather failed")
                return
            yield t

    def drain():
        try:
            write(items())
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller's thread
            failed.append(e)
            while not ended:  # keep taking to the end: the caller never blocks
                if (t := q.get()) is done or t is abort:
                    ended.append(t)

    writer = threading.Thread(target=drain, daemon=True)
    writer.start()
    ok = False
    try:
        for t in leaves:
            q.put(t)
        ok = True
    finally:
        q.put(done if ok else abort)
        writer.join()
    if failed and ok:
        raise failed[0]


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._awaited: int | None = None  # a step rank 0 writes for this rank

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, metadata: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot now (a copy on the host, taken before the caller's next
        in-place update), write on a thread unless ``blocking``."""
        # copy=True: .cpu() of a CPU tensor is the tensor itself, which the
        # next optimizer step would rewrite while the thread saves it
        leaves = tree_flatten(tree)
        structure = tree_structure(tree)
        self.wait()  # one in-flight save at a time
        if any(isinstance(t, DTensor) for t in leaves):
            if dist.get_rank() != 0:  # rank 0 writes, this rank gathers with it and waits
                for _ in _gathered(leaves, keep=False):
                    pass
                self._awaited = step
                if blocking:
                    self.wait()
                return
            if blocking:  # written as gathered: a leaf or two on the host at a time
                _written_behind(lambda ts: self._write(step, ts, structure, metadata or {}),
                                _gathered(leaves, keep=True))
                self._gc()
                return
            snapshot = list(_gathered(leaves, keep=True))
        else:
            snapshot = [t.detach().to("cpu", copy=True) for t in leaves]

        def work():
            self._write(step, snapshot, structure, metadata or {})
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _write(self, step, leaves, structure, metadata):
        path = self._path(step)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "treedef": f"PyTreeDef({structure})", "leaves": [],
                    "metadata": metadata}
        for i, t in enumerate(leaves):  # a list, or leaves made one at a time
            manifest["leaves"].append({"index": i, "shape": list(t.shape),
                                       "dtype": _dtype_name(t)})
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), _host_array(t))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, COMMITTED), "w") as f:
            f.write("ok")
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._awaited is not None:
            marker = os.path.join(self._path(self._awaited), COMMITTED)
            deadline = time.monotonic() + COMMIT_TIMEOUT_S
            while not os.path.exists(marker):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"rank 0 never committed {marker}")
                time.sleep(0.01)
            self._awaited = None

    # -- restore ---------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if name.startswith("step_") and os.path.exists(os.path.join(full, COMMITTED)):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: int | None = None, *, like: Any = None, device=None,
                sharding_fn: Callable[[int, np.ndarray], Any] | None = None
                ) -> tuple[int, Any, dict]:
        """Load (step, tree, metadata), the tensors on ``device`` (``None``
        means the card).  ``like`` gives the tree's structure (the shape of
        a tree that was saved, e.g. the state being resumed);
        ``sharding_fn(i, array) -> (mesh, placements)`` makes leaf ``i`` a
        DTensor on the *current* mesh, this rank holding its shard on the
        mesh's device (elastic restore)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint in {self.directory}")
        path = self._path(step)
        if not os.path.exists(os.path.join(path, COMMITTED)):
            raise FileNotFoundError(f"checkpoint {path} not committed (torn write?)")
        if like is None:
            raise ValueError("restore() needs `like=` for the tree structure")
        dev = None if sharding_fn is not None else resolve_device(device)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        for i, spec in enumerate(manifest["leaves"]):
            # sharded, a rank reads only its block's pages of the mapped file
            a = np.load(os.path.join(path, f"leaf_{spec['index']:05d}.npy"),
                        mmap_mode=None if sharding_fn is None else "c")
            if list(a.shape) != spec["shape"]:
                raise ValueError(f"leaf {spec['index']} of {path}: shape {a.shape}, "
                                 f"manifest {spec['shape']}")
            t = _tensor(a, spec["dtype"])
            leaves.append(t.to(dev) if sharding_fn is None else _sharded(t, *sharding_fn(i, a)))
        return step, tree_unflatten(like, leaves), manifest["metadata"]

    # -- misc ------------------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:06d}")

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)
