"""Captured serving steps: the port's counterpart of ``jax.jit``.

The JAX engine wraps each step in ``jax.jit``: one compiled program a
signature, launched as one unit.  Here a step is a plain function of the
pool's cache and a few small integer tensors, ``step(cache, **inputs) ->
dict of tensors``.  :class:`StepGraph` captures it once as a CUDA graph and
replays it on every later call, so a tick costs one graph launch on the
host instead of one launch per kernel (``graph.kernels``, read on an H100:
1,336 kernels for granite-3-8b's widths at 8 layers, on 32 slots of 1536 or
8 of 16384; 6,168 for granite-moe-3b-a800m's 32 layers).

* **Inputs.**  The per-tick host arrays (tokens, positions, the decode mask,
  drafts, and a paged pool's page table) are copied into static device
  buffers before each replay; the graph reads them there.  The table's
  values change from tick to tick, its buffer does not.  Nothing is built
  from numpy inside the step.
* **Outputs.**  The step's outputs are static tensors of the graph, read
  after each replay (and overwritten by the next).
* **The cache** is written in place at the addresses it had at capture, so
  the pool must never rebind it; a pool with other addresses (a new pool)
  gets a new graph (``signature``).  What the pool writes between ticks
  (an admission, a paged pool's copy-on-write copies) is enqueued on the
  current stream, the one a replay runs on, so the replay sees it.
* **Warm-up.**  The step runs once uncaptured on the capture stream before
  the capture: what a kernel wrapper allocates lazily per stream (K5's
  split-K workspace) then exists, and no allocation of it is captured.  The
  cache is put back as it was before the warm-up, so the first replay is
  the step's first application (an SSM state would otherwise advance
  twice).
* **Transients** the step allocates (activations, the verify tick's
  ``ssm.VerifyCarry``) come from the graph's own memory pool at capture
  and keep their addresses on every replay; only the cache, which outlives
  the step, is part of ``signature``.
* **Counters.**  A replay runs no Python, so no counter of the port
  (``core/tracing.py``: the kernels' launches, decode attention's rows)
  would move: the capture records every counter it moved, and each replay
  adds that record, with ``graph.kernels``, the kernel nodes of the graph
  (read once from the captured graph through the CUDA driver API).  The
  warm-up runs eagerly and counts as any eager call does.  No span is
  recorded during the warm-up or the capture.

On the CPU there is nothing to capture: the same step runs eagerly on the
same static buffers.  The engine's ``masked_decode_step`` and
``masked_speculative_step`` go through a StepGraph on every pool; prefill,
``generate`` and the chunked-prefill steps run eagerly, since their lengths
vary from call to call (ROADMAP Queue A item 9).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import tracing
from repro_torch.kernels import runtime

_NUMPY = {torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_}


def signature(cache: dict, *extra) -> tuple:
    """What a captured step depends on beyond its inputs' values: the cache
    tensors' addresses and shapes, and ``extra`` (batch, draft count)."""
    return (*extra, *((t.data_ptr(), tuple(t.shape)) for t in cache.values()))


class StepGraph:
    """``step(cache, **inputs)`` over static input buffers, captured as a
    CUDA graph at its first call on a CUDA device and replayed from then on;
    run eagerly on the CPU.

    ``inputs`` maps each input's name to its static buffer (device, dtype
    and shape fixed for the graph's life)."""

    def __init__(self, step, cache: dict, inputs: dict[str, torch.Tensor], *extra):
        self.step = step
        self.cache = cache
        self.inputs = inputs
        self.signature = signature(cache, *extra)
        self.device = next(iter(inputs.values())).device
        self.graph: torch.cuda.CUDAGraph | None = None
        self.stream: torch.cuda.Stream | None = None
        self.outputs: dict[str, torch.Tensor] | None = None
        self.counted: dict[str, int] = {}  # the counters a replay adds
        self.replays = 0

    @property
    def launches(self) -> dict[str, int]:
        """Kernel launches a replay runs, per kernel."""
        return runtime.launches_of(self.counted)

    @torch.inference_mode()
    def load(self, **arrays) -> None:
        """Copy host arrays into the static input buffers."""
        for name, a in arrays.items():
            buf = self.inputs[name]
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a, _NUMPY[buf.dtype])))

    @torch.inference_mode()
    def __call__(self, **arrays) -> dict[str, torch.Tensor]:
        """Load the inputs and :meth:`run` the step."""
        self.load(**arrays)
        return self.run()

    @torch.inference_mode()
    def run(self) -> dict[str, torch.Tensor]:
        """Run the step on the loaded inputs: replayed on a CUDA device
        (captured first if it was not), eagerly on the CPU."""
        if self.device.type == "cpu":
            return self.step(self.cache, **self.inputs)
        if self.graph is None:
            self._capture()
        return self.replay()

    @torch.inference_mode()
    def eager(self, cache: dict | None = None) -> dict[str, torch.Tensor]:
        """Run the step uncaptured on the loaded inputs, on ``cache`` (the
        pool's by default) and, on a CUDA device, on the capture stream, as
        the warm-up before the capture does."""
        cache = self.cache if cache is None else cache
        if self.device.type == "cpu":
            return self.step(cache, **self.inputs)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = self.step(cache, **self.inputs)
        current.wait_stream(self.stream)
        return out

    def _capture(self) -> None:
        # The warm-up writes the cache; what it wrote is put back, so that the
        # first replay starts from the cache the caller left.
        saved = {k: t.clone() for k, t in self.cache.items()}
        with tracing.paused():
            self.eager()
        for k, t in saved.items():
            self.cache[k].copy_(t)
        del saved
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with tracing.recorded() as captured:
            with torch.cuda.graph(graph, stream=self.stream):
                self.outputs = self.step(self.cache, **self.inputs)
        graph.instantiate()
        self.counted = dict(captured, **{"graph.kernels": kernel_nodes(graph.raw_cuda_graph())})
        self.graph = graph

    @torch.inference_mode()
    def replay(self) -> dict[str, torch.Tensor]:
        """Replay the captured step on the current stream; its static
        outputs hold the result."""
        self.graph.replay()
        for name, n in self.counted.items():
            tracing.count(name, n)
        self.replays += 1
        return self.outputs


_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL (cuda.h)


def kernel_nodes(raw_graph: int) -> int:
    """The kernel nodes of a captured ``cudaGraph_t`` (``CUDAGraph(keep_graph=True)
    .raw_cuda_graph()``), read through the CUDA driver API: the kernels one
    replay runs (its copy and memset nodes are not kernels)."""
    lib = ctypes.CDLL("libcuda.so.1")
    get_nodes, node_type = lib.cuGraphGetNodes, lib.cuGraphNodeGetType
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    node_type.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    get_nodes.restype = node_type.restype = ctypes.c_int

    def check(rc: int, what: str) -> None:
        if rc:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    graph, n = ctypes.c_void_p(raw_graph), ctypes.c_size_t(0)
    check(get_nodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(get_nodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, kernels = ctypes.c_int(-1), 0
    for node in nodes[:n.value]:
        check(node_type(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        kernels += kind.value == _KERNEL_NODE
    return kernels
