"""A world of ranks on one machine: spawned processes, one a rank, each
with its process group started, for tests and the chip smoke run.

``run_world(fn, world, backend=..., init_file=...)`` spawns ``world``
processes; rank ``r`` starts ``torch.distributed`` with the named backend
(``"gloo"`` or ``"nccl"``: an argument, never guessed) from a ``FileStore``
at ``init_file`` (no TCP port, so several worlds can run side by side),
selects its card when ``device_type`` is ``"cuda"`` (rank modulo the
cards), runs ``fn(rank, world, *args)`` and sends its result back.  The
results come back in rank order; a rank that raised fails the world with its
traceback.  Every process is joined, or killed when the world fails or runs
past ``timeout_s``, before ``run_world`` returns or raises.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Any, Callable


def _rank_main(fn, rank, world, backend, init_file, device_type, args, out):
    import torch
    import torch.distributed as dist

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world)
        try:
            out.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the world
        out.put((rank, False, traceback.format_exc()))
        raise


def run_world(fn: Callable, world: int, *, backend: str, init_file: str,
              device_type: str = "cpu", args: tuple = (), timeout_s: float = 600.0) -> list[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    computed in its own process of one world."""
    if os.path.exists(init_file):
        raise FileExistsError(f"{init_file} exists: a FileStore must start from no file")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, init_file, device_type, args, out))
             for r in range(world)]
    results: dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world of {world} past {timeout_s} s") from None
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and out.empty():
                    raise RuntimeError(f"rank process exited with {dead[0].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
