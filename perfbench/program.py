"""The system under test: the port's ``InferenceEngine`` on a contiguous slot
pool, built from a configuration file and the weights the benchmark made.

This is the only module of the benchmark that imports the program.  The
weights are handed over in the types they are served in (int8 projections
as the port's ``QuantTensor``, which ``quantize_params`` passes through), so
the program derives nothing from them that the reference would not see.
"""
from __future__ import annotations

import dataclasses

import torch


def arch_config(cfg: dict, model, *, rehearsal: bool = False):
    """The port's ``ArchConfig`` for a configuration file: its registered
    architecture (``program_arch``) cut as the file says
    (``model.arch_overrides``), int8 weights, each width checked against
    the file's (``model.check_arch``); ``rehearsal`` takes the port's
    reduced config instead (the CPU rehearsal's tiny sizes), with the
    file's ``rehearsal.arch`` put over it (a nested dict replaces fields of
    the nested config)."""
    from repro_torch.configs import get_config, get_reduced_config

    if rehearsal:
        arch = get_reduced_config(cfg["program_arch"])
        over = {k: dataclasses.replace(getattr(arch, k), **v) if isinstance(v, dict) else v
                for k, v in cfg.get("rehearsal", {}).get("arch", {}).items()}
        return dataclasses.replace(arch, **over, quant="int8")
    arch = dataclasses.replace(get_config(cfg["program_arch"]), **model.arch_overrides(cfg),
                               quant="int8")
    model.check_arch(arch, cfg)
    return arch


def program_params(w: dict, cfg: dict, arch, model) -> dict:
    """The port's parameter tree over the benchmark's weights
    (``model.program_tree``, int8 projections as the port's
    ``QuantTensor``), its shapes checked against the port's own
    ``param_defs``."""
    from repro_torch.models.model import param_defs
    from repro_torch.models.quant import QuantTensor

    params = model.program_tree(w, cfg, QuantTensor)

    def check(p, d, path):
        if isinstance(d, dict):
            if set(p) != set(d):
                raise ValueError(f"{path}: keys {sorted(p)} are not the port's {sorted(d)}")
            for k in d:
                check(p[k], d[k], f"{path}/{k}")
            return
        t = p.q if isinstance(p, QuantTensor) else p
        if tuple(t.shape) != tuple(d.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, the port's {tuple(d.shape)}")

    check(params, param_defs(arch), "params")
    return params


def make_engine(arch, params, pool: dict, device):
    """The engine and its contiguous pool (``pool``: max_batch, max_len)."""
    from repro_torch.serving.engine import InferenceEngine, ServeConfig

    sc = ServeConfig(max_batch=pool["max_batch"], max_len=pool["max_len"])
    eng = InferenceEngine(arch, params=params, sc=sc, device=device)
    return eng, eng.make_pool()


def k5_launches() -> int:
    """The port's count of ``int8_matmul`` launches so far (a replayed
    graph adds what it captured)."""
    from repro_torch.kernels import runtime

    return runtime.launch_counts().get("int8_matmul", 0)


def warm_k5_plans(calls) -> None:
    """Resolve the kernel's launch geometry for every (m, k, n, batch) the
    cell will launch, so that the tuner runs in set-up and not in the
    window (its picks are then also on disk for the next run).  The
    tuner's disk cache is read once first: it re-reads the whole file for
    each key it does not hold in memory, which at a granite-moe cell's
    ~5,000 shapes takes longer than serving them."""
    from repro_torch.kernels import autotune, int8_matmul, runtime

    memory, load = getattr(autotune, "_CACHE", None), getattr(autotune, "_load_disk", None)
    valid = getattr(autotune, "_valid_entry", None)
    if isinstance(memory, dict) and load is not None and valid is not None:
        memory.update({k: v for k, v in load().items()
                       if k not in memory and valid(k.split("|")[0], v)})
    for m, k, n, batch in calls:
        int8_matmul.plan(m, k, n, backend=runtime.CUDA_BACKEND, batch=batch)


def free_cuda() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
