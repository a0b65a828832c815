"""Captured serving steps: the port's counterpart of ``jax.jit``.

The JAX engine wraps each step in ``jax.jit``: one compiled program a
signature, launched as one unit.  Here a step is a plain function of the
pool's cache and a few small integer tensors, ``step(cache, **inputs) ->
dict of tensors``.  :class:`StepGraph` captures it once as a CUDA graph and
replays it on every later call, so a tick costs one graph launch on the
host instead of one launch per kernel (about 1300 at granite-3-8b's width).

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
* **Launch counts.**  A replay runs no wrapper, so the kernels' launch
  counters (``kernels/runtime.py``) would not move: the graph records what
  the capture launched, per kernel, and adds it on each replay.

On the CPU there is nothing to capture: the same step runs eagerly on the
same static buffers.  The engine's ``masked_decode_step`` and
``masked_speculative_step`` go through a StepGraph on every pool; prefill,
``generate`` and the chunked-prefill steps run eagerly, since their lengths
vary from call to call (ROADMAP Queue A item 9).
"""
from __future__ import annotations

import numpy as np
import torch

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
        self.launches: dict[str, int] = {}  # kernel launches a replay runs
        self.replays = 0

    @torch.inference_mode()
    def load(self, **arrays) -> None:
        """Copy host arrays into the static input buffers."""
        for name, a in arrays.items():
            buf = self.inputs[name]
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a, _NUMPY[buf.dtype])))

    @torch.inference_mode()
    def __call__(self, **arrays) -> dict[str, torch.Tensor]:
        """Load the inputs and run the step: replayed on a CUDA device
        (captured first if it was not), eagerly on the CPU."""
        self.load(**arrays)
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
        self.eager()
        for k, t in saved.items():
            self.cache[k].copy_(t)
        del saved
        graph = torch.cuda.CUDAGraph()
        with runtime.launches_recorded() as captured:
            with torch.cuda.graph(graph, stream=self.stream):
                self.outputs = self.step(self.cache, **self.inputs)
        self.graph, self.launches = graph, dict(captured)

    @torch.inference_mode()
    def replay(self) -> dict[str, torch.Tensor]:
        """Replay the captured step on the current stream; its static
        outputs hold the result."""
        self.graph.replay()
        for kernel, n in self.launches.items():
            runtime.count_launch(kernel, n)
        self.replays += 1
        return self.outputs
