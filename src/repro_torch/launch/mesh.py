"""Production mesh construction, as ``torch.distributed`` device meshes.

Functions, not module-level constants: building a mesh needs the process
group, which the caller starts (``torch.distributed.init_process_group``
with its backend named: ``"nccl"`` for one rank a card, ``"gloo"`` where
ranks share a card or run on the CPU).

Topology (the reference's, ``repro.launch.mesh``): one pod of 16×16 = 256
devices, axes ("data", "model") — "model" is the TP/EP/SP axis, "data" the
DP/FSDP axis.  Multi-pod adds a leading "pod" axis: pure DP across pods.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(device_type: str, shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    need = math.prod(shape)
    world = dist.get_world_size()
    if world < need:
        raise RuntimeError(f"mesh {shape} needs {need} ranks, the world has {world}: start "
                           f"the process group with world_size={need} or more")
    if world == need:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return DeviceMesh(device_type, torch.arange(need).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model"),
    over the world's first 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """(1, world) ("data", "model") over every rank of the world."""
    return _mesh(device_type, (1, dist.get_world_size()), ("data", "model"))
