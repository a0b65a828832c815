"""Kernels a decode tick runs: the program's ``graph.kernels`` (the kernel
nodes of the replayed CUDA graph, counted once from the graph and added a
replay) over its ``tick`` spans inside the window (recorded while a
profiler records, ``repro_torch.core.tracing``).  Nothing is read where no
graph was captured (the CPU) or the program has no tracer."""
import sys


def read(run):
    tracing = sys.modules.get("repro_torch.core.tracing")
    if tracing is None:
        return None
    ticks = kernels = 0
    for s in tracing.spans():
        if s.name == "tick" and run.t0 * 1e9 <= s.t0 and s.t1 <= run.t1 * 1e9:
            ticks += 1
            kernels += s.counters.get("graph.kernels", 0)
    return kernels / ticks if kernels else None
