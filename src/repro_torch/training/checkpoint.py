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
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.params import tree_flatten, tree_structure, tree_unflatten

COMMITTED = "COMMITTED"
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


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, metadata: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot now (a copy on the host, taken before the caller's next
        in-place update), write on a thread unless ``blocking``."""
        # copy=True: .cpu() of a CPU tensor is the tensor itself, which the
        # next optimizer step would rewrite while the thread saves it
        snapshot = [t.detach().to("cpu", copy=True) for t in tree_flatten(tree)]
        structure = tree_structure(tree)
        self.wait()  # one in-flight save at a time

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
        manifest = {
            "step": step,
            "treedef": f"PyTreeDef({structure})",
            "leaves": [{"index": i, "shape": list(t.shape), "dtype": _dtype_name(t)}
                       for i, t in enumerate(leaves)],
            "metadata": metadata,
        }
        for i, t in enumerate(leaves):
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

    # -- restore ---------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if name.startswith("step_") and os.path.exists(os.path.join(full, COMMITTED)):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: int | None = None, *, like: Any = None,
                device=None) -> tuple[int, Any, dict]:
        """Load (step, tree, metadata), the tensors on ``device`` (``None``
        means the card).  ``like`` gives the tree's structure (the shape of
        a tree that was saved, e.g. the state being resumed)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint in {self.directory}")
        path = self._path(step)
        if not os.path.exists(os.path.join(path, COMMITTED)):
            raise FileNotFoundError(f"checkpoint {path} not committed (torn write?)")
        if like is None:
            raise ValueError("restore() needs `like=` for the tree structure")
        dev = resolve_device(device)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        for spec in manifest["leaves"]:
            a = np.load(os.path.join(path, f"leaf_{spec['index']:05d}.npy"))
            if list(a.shape) != spec["shape"]:
                raise ValueError(f"leaf {spec['index']} of {path}: shape {a.shape}, "
                                 f"manifest {spec['shape']}")
            leaves.append(_tensor(a, spec["dtype"]).to(dev))
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
