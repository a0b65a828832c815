#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds every CUDA kernel of ``src/repro_torch/csrc`` from source, holds each
against its plain PyTorch version on the card at the shapes its path uses,
times kernel, plain version and (where one PyTorch call computes the same
function) the library, then drives nine paths, each with the launch
counters set to 0 just before it and read just after:

* the paper-LSTM path — the plan and request batches through ``lstm_apply``
  and ``lstm_stack_apply`` in every mode (K1–K4);
* ``serve_dense`` — int8-weight serving of granite-3-8b at full width (8 of
  its 40 layers, bf16, ``quant="int8"``) through ``InferenceEngine.generate``
  and the slot path ``make_pool`` → ``prefill_into_slot`` →
  ``masked_decode_step`` (a replayed CUDA graph), every projection through
  ``int8_matmul`` (K5);
* ``serve_engine`` — the same weights with ``spec_slack=4``: chunked prefill
  of 2 x 64 tokens in chunks of 16 while two slots decode, speculative
  verify (K = 4) teacher-forced from the plain decode chain (per-position
  agreement >= 0.95, accept-0 on always-wrong drafts), poison → quarantine
  → ``resume_into_slot``, the replayed decode and verify ticks held bit for
  bit to the same steps run eagerly, and the reduced granite config in f32
  with int8 weights: chunked == blocking and speculative == plain, token
  for token.  K5 launches 7 x layers times a chunk, verify and replayed
  tick;
* ``duty_cycle`` — the paper's RQ2 layer on the same int8 weights
  (``ServeConfig(max_batch=4, max_len=128)``): ``WorkloadAwareServer``'s
  ``measure_latency`` (the eager ``generate`` of 4 x 16 prompts, 8 new
  tokens; the median of 3) beside ``serve_engine``'s replayed decode tick;
  the three ``AccelProfile`` constants measured for this engine
  (``power.draw`` idle and during a 2.5 s ``generate`` loop, a pinned
  host-to-device copy of its weight tensors) beside ``H100Chip`` and
  ``gpu_reload_costs``; ``compare_strategies`` under the chip's profile and
  the measured one on regular traces at 0.05 and 20 break-even τ and a
  seeded bursty trace, the engine run during each (on-off <= idle-waiting
  at short gaps, idle-waiting <= on-off at long, adaptive >= 0.45 x the
  best); a ``StreamingTauPolicy`` refitting on the card within 10% of
  offline ``learn_tau``; ``NgramDrafter`` + ``SpecThrottle`` drafts for 4
  periodic prompts verified on the replayed verify tick, the chains equal
  to plain decode token for token.  K5 launches 56 a model call;
* ``serve_moe`` — the moe family through the same engine: granite-moe-3b-a800m
  at full width and full depth (32 layers, 48 padded experts, bf16, int8:
  ``generate``, the slot path with replayed ticks, a chunked prefill while
  slots decode, a verify tick of K = 4 teacher-forced from the plain chain),
  then deepseek-v3-671b at full width cut to 2 layers (one MLA + dense-MLP,
  one MLA + MoE with 256 experts and a shared one: ``generate`` and replayed
  ticks), each with its replayed ticks bit for bit equal to the eager ones,
  greedy agreement with its bf16 twin >= 0.3 and one block on the card
  against the CPU; then both reduced configs in f32 (granite-moe's with int8
  weights; deepseek's MLA prefill and chunk paths round int8 differently, so
  its identities hold with full-precision weights only), chunked == blocking
  and speculative == plain, token for token.  Every
  expert einsum is ONE K5 launch over the expert axis; the counts a call
  makes are ``k5_per_call``'s;
* ``serve_ssm`` — the ssm and hybrid families through the same engine, each
  at full width and full depth: mamba2-780m (48 Mamba2 layers) and zamba2-7b
  (81 Mamba2 layers, the weight-shared attention block applied 14 times),
  bf16 with int8 weights and a bf16 twin: ``generate``, the slot path with
  the replayed decode tick timed and profiled beside the bytes it must move,
  a chunked prefill while slots decode, verify ticks teacher-forced from the
  plain chain (each row's conv tail and SSM state rolled to its own accepted
  count), accept-0, poison/resume, replayed ticks bit for bit equal to eager
  ones, a 512-token prompt (two 256-token SSD chunks) against its chunked
  composition, agreement with the bf16 twin >= 0.3, one Mamba2 block and
  the shared block on the card against the CPU; then both reduced configs
  in f32 with int8 weights, chunked == blocking and speculative == plain,
  token for token.  K5 launches 3 a Mamba2 layer and 9 a shared-block
  application a call (``k5_per_call``);
* ``serve_audio`` — the enc-dec audio family through the same engine:
  whisper-tiny at full width and full depth (4 encoder + 4 decoder layers,
  encoder_seq 1500, vocab 51865 tied), bf16 with int8 weights and a bf16
  twin, the same steps as ``serve_ssm`` (the chunked group's cross K/V from
  ``encoder_cross_cache`` of the front-end stub, the resumed slot's cross
  K/V a fresh prefill's, bit for bit), the replayed decode tick beside the
  bytes it must move (the decoder's weights, the tied table, the cross K/V
  of 4 slots), one prompt over seeded random frames held to its chunked
  composition, the encoder and decoder blocks on the card against the CPU;
  then the reduced config in f32 with int8 weights, token for token.  K5
  launches 6 an encoder layer, 10 a decoder layer at prefill and 8 at the
  other calls, every encoder and cross K/V product at M = B x 1500;
* ``serve_vlm`` — the vision-language model: internvl2-76b at full width
  (d_model 8192, 64 heads, GQA kv 8, d_ff 28672, vocab 128256 untied) cut
  80 → 8 layers, its prompts 256 image positions (the engine's stub) and
  then text, the same steps (the chunked prefill in chunks of 48, one of
  which straddles position 256; a prefill of seeded random patch
  embeddings against its chunked composition), 7 K5 launches a layer;
* ``flash_attention`` — its public op ``kernels.ops.flash_attention`` at a
  granite-shaped causal case (K6; no model path calls it).

Every profiled sample must hold one kernel event of the port's kernels for
each launch the counters saw (a replayed graph counts the launches it
captured); a sample that loses events is taken again and, failing three
times, reported as null (``main_path.trace_check``).

K5 is held to its plain version bit for bit at every shape, on two calls in
a row (its split-K counters and workspace must come back to zero), the
expert shapes of the moe family as one batched launch too (timed beside the
same products as E separate launches); K6 within
2e-5 in f32 and 3e-2 in bf16.  The SASS of the tensor-core kernels must hold
HMMA (K6 bf16) and IMMA (K5) where the toolkit has ``cuobjdump``.  K3 and
K4 run their cluster path at D = H = 256 (the plan and the card's cluster
occupancy are in their entries) and are held to their plain versions there
too, with a forced batch tile that leaves a ragged last cluster, and at a
batch of 200 whose input projection no longer fits at once (it runs in
chunks of steps); K4 also at four layers.  K2's entry gives its geometry
(units and rows a block, grid); with ``--parent DIR``, a checkout of the
parent commit, the parent's K2 is built from DIR and timed beside it.

The ``tuner`` phase holds the block-size tuner (``kernels/autotune.py``) to
the card: at every K2-K6 shape of the paths it times the tuner's pick beside
the fixed plan the tuner replaced (passed explicitly), the analytic top 6
and a spread of probes, refines the top 3 by measurement
(``bench.make_measure_fn``) in a cache directory of its own, holds every
output to its plain version, and refits the model's constants to this run's
timings (``tuner.fit``).  The ``chip_model`` phase checks ``H100Chip``
against the card's properties, and ``energy`` reads ``power.draw`` idle and
under a 2 s K3 loop beside ``H100Chip.step_power``.

Lines printed, in order: ``env``, the card, ``build`` (with the SASS check),
``phase`` lines (seconds per phase), ``serve_dense``, ``serve_engine`` (with
the replayed and eager tick times), ``serve_moe``, ``serve_ssm``,
``serve_audio``, ``serve_vlm``, ``duty_cycle``, ``int8_path_shapes``,
``host_path`` (each kernel wrapper's host time, ``"auto"`` against the same plan passed
explicitly, and K1's host path piece by piece), ``chip_model``, ``tuner``,
``energy``, one JSON object ``{"kernels": [...]}``,
``main_path``, the card as ``nvidia-smi`` names it, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is then
not 0 and the last line is not printed.  ``--out FILE`` also writes the whole
report as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import importlib.util
import json
import math
import pathlib
import re
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.energy import DEFAULT_CHIP  # noqa: E402
from repro_torch.core.fpga import paper_workload  # noqa: E402
from repro_torch.kernels import bench, ops, runtime  # noqa: E402
from repro_torch.kernels.activations import (  # noqa: E402
    activation, activation_plain, impl_code, table_pointer,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, flash_attention, flash_attention_plain, flash_smem_bytes,
)
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain, plan  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.lstm_cell import lstm_cell_fused, lstm_cell_plain  # noqa: E402
from repro_torch.kernels.lstm_cell import plan as cell_plan  # noqa: E402
from repro_torch.kernels.lstm_quant import quantize_lstm_stack, quantize_lstm_weights  # noqa: E402
from repro_torch.kernels.lstm_seq import (  # noqa: E402
    _lstm_stack_call, cluster_slots, lstm_seq_fused, lstm_seq_fused_quantized, lstm_seq_plain,
    lstm_stack_fused, lstm_stack_plain, plan_launch,
)
from repro_torch.launch.train import plan_paper_lstm  # noqa: E402
from repro_torch.models.lstm import lstm_apply, lstm_stack_apply  # noqa: E402
from repro_torch.kernels import int8_matmul as int8_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import quant as quant_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.layers import unembed_apply  # noqa: E402
from repro_torch.models.model import init_model  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params, params_from_numpy, tree_leaves, tree_map,
)
from repro_torch.models.quant import QuantTensor, layer_of, quantize_weight  # noqa: E402
from repro_torch.core import workload as workload_mod  # noqa: E402
from repro_torch.serving import draft as draft_mod  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import load as load_mod  # noqa: E402
from repro_torch.serving import policy as policy_mod  # noqa: E402
from repro_torch.serving.kv_cache import cache_defs  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# the f32 rate outside the tensor cores, and the dense tensor-core rates of
# bf16 and int8.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12

IMPLS = ("exact", "pwl", "lut", "hard")
PAPER_BATCH = 64
SCALED_SHAPE = (32, 64, 16, 32)            # (B, S, D, H)
QUANT_SHAPE = (40, 28, 256, 256)
STACK_SHAPE = (40, 28, 256, 256, 3)        # (B, S, D, H, L)
RAGGED_BATCH = 33
RAGGED_TILE = 7                            # K3 rows a cluster at QUANT_SHAPE: 5 x 7 + 5
CHUNK_SHAPE = (200, 28, 256, 256)          # K3's projection in chunks: 1 step (f32), 15 (int8)
REQUESTS = 8

# Kernel against plain version, on the card.  f32: the two sum the products
# in another order and the kernel contracts multiply-adds, so they differ in
# the last bits, carried through S steps: 2e-5, absolute and relative, as the
# reference's own kernel tests.  int8 weights: 1e-4, as those tests.
# impl="lut" is discontinuous: a pre-activation that differs in its last bits
# can land in the neighbouring table bin.  One such flip moves a sigmoid by up
# to one table step (0.25 * 8/255 = 7.8e-3) and a tanh, which is 2σ(2x) − 1,
# by up to 1.57e-2; the changed h then enters every gate of its row at the
# next step, so at H = 256 a flip leaves most of the row's later elements a
# little over the f32 tolerance, and a few flips compound.  The share of
# elements over the tolerance is therefore unbounded at these widths; what a
# right kernel does keep small is the mean.  The rule for lut in a recurrence:
# mean error at most 2e-3 and no element above 5e-2 (three tanh steps); a
# wrong table, index or gate order fails both by an order of magnitude.
TOL_F32, TOL_Q8 = 2e-5, 1e-4
LUT_MAX, LUT_MEAN = 5e-2, 2e-3
LUT_SEEN: dict[str, dict] = {}   # worst lut statistics seen, by check


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------
def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def compare(got, want, impl: str, tol: float, what: str, same_inputs: bool = False) -> float:
    """Max abs error; fails when the rule for ``impl`` is broken.  The two-part
    lut rule applies unless both sides feed the table the very same numbers
    (``same_inputs``: the elementwise kernel)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite values")
    err = (got - want).abs()
    worst = float(err.max())
    above = err > tol + tol * want.abs()
    if impl == "lut" and not same_inputs:
        mean, share = float(err.mean()), float(above.float().mean())
        seen = LUT_SEEN.setdefault(what, {"max": 0.0, "mean": 0.0, "share_over_tolerance": 0.0})
        seen.update(max=max(seen["max"], worst), mean=max(seen["mean"], mean),
                    share_over_tolerance=max(seen["share_over_tolerance"], share))
        if worst > LUT_MAX or mean > LUT_MEAN:
            fail(f"{what} [lut]: max err {worst:.3e} (limit {LUT_MAX}), mean {mean:.3e} "
                 f"(limit {LUT_MEAN})")
    elif bool(above.any()):
        fail(f"{what} [{impl}]: max err {worst:.3e} over tolerance {tol}")
    return worst


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of (CUDA-event time of ``reps`` calls) / reps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    return statistics.median(samples)


def time_pair(fn, library, reps: int = 20, rounds: int = 7) -> tuple[float, float]:
    """``time_ms`` of ``fn`` and of ``library`` in alternating rounds, so
    that a drift of the card's clock or of the host's load reaches both."""
    a, b = [], []
    for _ in range(rounds):
        a.append(time_ms(fn, reps=reps, rounds=1))
        b.append(time_ms(library, reps=reps, rounds=1))
    return statistics.median(a), statistics.median(b)


def warm_card(dev, seconds: float = 1.0) -> None:
    """Bring the card's clocks up from idle before anything is timed:
    back-to-back products for about ``seconds``."""
    a = torch.randn((4096, 4096), device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = a @ a
            a = a / a.abs().amax()
        torch.cuda.synchronize()


# Profiled samples whose trace lost kernel events: taken again, and never
# reported when every try lost some (``device_ms`` returns None then).
TRACE_CHECK = {"samples": 0, "retaken": 0, "dropped": 0}


def port_kernel_events(prof) -> int:
    """Kernel events of the port's own kernels in a trace: every kernel of
    ``csrc/`` lives in namespace ``repro``."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "repro::" in e.key)


def profiled(fn, reps: int = 1, uncounted: int = 0, activities=None):
    """``reps`` calls of ``fn`` under ``torch.profiler``, taken again (up to
    three tries) until the trace holds one kernel event for every launch the
    port's counters saw in the window (a replayed graph counts the launches
    it captured) plus ``uncounted`` a call (a kernel launched past the
    counters).  Returns (profile, wall ms of the window), or None when every
    try lost events or showed no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    TRACE_CHECK["samples"] += 1
    for attempt in range(3):
        torch.cuda.synchronize()
        before = sum(runtime.launch_counts().values())
        with profile(activities=activities or [ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launched = sum(runtime.launch_counts().values()) - before + uncounted * reps
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
        if busy > 0 and port_kernel_events(prof) == launched:
            TRACE_CHECK["retaken"] += attempt
            return prof, wall_ms
    TRACE_CHECK["retaken"] += 2
    TRACE_CHECK["dropped"] += 1
    return None


def device_ms(fn, reps: int = 10, uncounted: int = 0):
    """GPU-busy time of one call in ms: the device time of every kernel the
    call launches, from the profiler's trace, without the host's share.
    ``None`` if no trace held every launched kernel (``profiled``)."""
    from torch.autograd import DeviceType

    fn()
    sample = profiled(fn, reps=reps, uncounted=uncounted)
    if sample is None:
        return None
    total_us = sum(e.self_device_time_total for e in sample[0].key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / reps / 1e3


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time the card could take, in ms, and which limit sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# Operations per activation and per cell update, as the reference's cost
# weights count them (exp + add + div ≈ 12 for an exact sigmoid).
ACT_OPS, CELL_OPS = 12, 4


def lstm_flops(batch, seq, d_in, hidden, layers=1) -> float:
    macs = batch * seq * 4 * hidden * ((d_in + hidden) + (layers - 1) * 2 * hidden)
    return 2.0 * macs + layers * batch * seq * hidden * (5 * ACT_OPS + CELL_OPS)


def make_lstm(seed: int, batch, seq, d_in, hidden, layers, dev):
    """Inputs and weights from a numpy seed; weights std 1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, d_in)).astype(np.float32)
    tree = []
    for l in range(layers):
        fan = d_in if l == 0 else hidden
        tree.append({
            "w": (rng.standard_normal((fan, 4 * hidden)) / np.sqrt(fan)).astype(np.float32),
            "u": (rng.standard_normal((hidden, 4 * hidden)) / np.sqrt(hidden)).astype(np.float32),
            "b": (rng.standard_normal((4 * hidden,)) * 0.1).astype(np.float32),
        })
    return torch.from_numpy(x).to(dev), params_from_numpy(tree, dev)


def entry(name, source, replaces, shapes):
    """One element of the ``kernels`` line; the first shape is the main
    path's, and its numbers (impl="exact") are the entry's own."""
    main = shapes[0]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "device_ms": main["device_ms"], "tolerance": main["tolerance"], "shapes": shapes,
    }


def r6(v):
    return None if v is None else float(f"{v:.6g}")


# The tensor-core kernels and the SASS opcode each of their instantiations
# must hold: bf16 mma.sync is HMMA, s8 mma.sync is IMMA.
TENSOR_CORE_KERNELS = {"flash_attention_bf16_kernel": "HMMA", "int8_matmul_kernel": "IMMA"}


def ptxas_usage(log: str) -> list[dict]:
    """Registers, static shared memory, stack and spills of every
    instantiation of the tensor-core kernels, from ``nvcc -Xptxas -v``."""
    out, cur = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = found.group(1)
            cur = {"kernel": name} if any(k in name for k in TENSOR_CORE_KERNELS) else None
            if cur:
                out.append(cur)
            continue
        if cur is None:
            continue
        for key, pattern in (("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill stores"),
                             ("spill_load_bytes", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("static_smem_bytes", r"(\d+) bytes smem")):
            found = re.search(pattern, line)
            if found:
                cur[key] = int(found.group(1))
    return out


def sass_tensor_ops() -> dict | None:
    """Per instantiation of the tensor-core kernels, how many HMMA / IMMA
    instructions ``cuobjdump -sass`` finds in the built library; fails when
    one has none.  ``None`` where the toolkit has no ``cuobjdump``."""
    tool = pathlib.Path(runtime._find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    lib = runtime.BUILD_DIR / f"libkernels-{runtime._sources_hash()}.so"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            family = next((k for k in TENSOR_CORE_KERNELS if k in name), None)
            cur = name if family else None
            if cur:
                counts[cur] = {"family": family, "op": TENSOR_CORE_KERNELS[family], "count": 0}
        elif cur and re.search(rf"\b{counts[cur]['op']}\b", line):
            counts[cur]["count"] += 1
    for family in TENSOR_CORE_KERNELS:
        if not any(c["family"] == family for c in counts.values()):
            fail(f"SASS: no instantiation of {family} in {lib.name}")
    for name, c in counts.items():
        if c["count"] == 0:
            fail(f"SASS: {name} holds no {c['op']} instruction")
    return counts


# ---------------------------------------------------------------------------
# Kernel phases: each holds a kernel against its plain version per impl and
# shape, then times kernel, plain version and library at impl="exact".
# ---------------------------------------------------------------------------
def check_activation(dev):
    b, s, _, h = QUANT_SHAPE
    cases = [((b, s, h), torch.float32), ((4096, 4096), torch.float32),
             ((3, 33, 130), torch.float32), ((128, 256), torch.bfloat16)]
    library = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
               "silu": torch.nn.functional.silu,
               "gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh")}
    shapes = []
    for shape, dtype in cases:
        gen = torch.Generator().manual_seed(len(shapes))
        x = (torch.randn(shape, generator=gen) * 4.0).to(dtype).to(dev)
        tol = 2e-2 if dtype == torch.bfloat16 else TOL_F32
        errs = {}
        for fn in ("sigmoid", "tanh", "silu", "gelu"):
            for impl in IMPLS:
                got = activation(x, fn=fn, impl=impl)
                want = activation_plain(x, fn=fn, impl=impl)
                errs[f"{fn}/{impl}"] = compare(got, want, impl, tol, f"activation {fn} {shape}",
                                               same_inputs=True)
        torch.cuda.synchronize()
        bound_ms, bound_by = bound(2 * nbytes(x), x.numel() * ACT_OPS)
        ms, library_ms = time_pair(lambda: activation(x, fn="sigmoid", impl="exact"),
                                   lambda: torch.sigmoid(x))
        shapes.append({
            "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": max(errs.values()), "err_by_impl": {
                impl: r6(max(v for k, v in errs.items() if k.endswith(impl))) for impl in IMPLS},
            "tolerance": tol, "ms": r6(ms),
            "device_ms": r6(device_ms(lambda: activation(x, fn="sigmoid", impl="exact"))),
            "plain_ms": r6(time_ms(lambda: activation_plain(x, fn="sigmoid", impl="exact"))),
            "library_ms": r6(library_ms), "ms_over_library": r6(ms / library_ms),
            "ms_by_fn_exact": {fn: r6(time_ms(lambda: activation(x, fn=fn, impl="exact"), reps=10,
                                              rounds=3)) for fn in library},
            "library_ms_by_fn": {fn: r6(time_ms(lambda: call(x), reps=10, rounds=3))
                                 for fn, call in library.items()},
            "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    return entry("activation", "src/repro_torch/csrc/activations.cu",
                 "src/repro/kernels/activations.py:118", shapes)


def load_parent_cell(parent: pathlib.Path | None, dev):
    """K2 of another checkout (``--parent DIR``: the parent commit, unpacked
    with ``git archive`` under the git-ignored ``build/``), built alone from
    its ``csrc/lstm_cell.cu`` into its own library and planned by its own
    ``kernels/lstm_cell.py``, so that both versions of the kernel are timed
    in one run on one card.  Returns ``call(x, h, c, w, u, b) -> (h', c')``
    at impl="exact" and ``block_b="auto"``, or None without ``--parent``."""
    if parent is None:
        return None
    lib_path = runtime.BUILD_DIR / "parent" / "liblstm_cell.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([runtime._find_nvcc(), *runtime.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(parent / "src" / "repro_torch" / "csrc" / "lstm_cell.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).repro_lstm_cell
    fn.argtypes, fn.restype = [ctypes.c_char_p, ctypes.c_int], ctypes.c_int
    spec = importlib.util.spec_from_file_location(
        "parent_lstm_cell", parent / "src" / "repro_torch" / "kernels" / "lstm_cell.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    pack = struct.Struct("16q").pack

    def call(x, h, c, w, u, b):
        batch, d_in = x.shape
        rows, smem = module._cell_plan("auto", batch, d_in, h.shape[1])
        h_new, c_new = torch.empty_like(h), torch.empty_like(c)
        rc = fn(pack(x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(), u.data_ptr(),
                     b.data_ptr(), table_pointer(dev, impl_code("exact")), h_new.data_ptr(),
                     c_new.data_ptr(), batch, d_in, h.shape[1], impl_code("exact"), rows, smem,
                     runtime.stream_handle(dev)), 16)
        if rc:
            fail(f"the parent's lstm_cell refused its launch (code {rc})")
        return h_new, c_new

    return call


def check_cell(dev, parent: pathlib.Path | None = None):
    lw = paper_workload()
    cases = [QUANT_SHAPE, (PAPER_BATCH, lw.seq, lw.d_in, lw.hidden), SCALED_SHAPE,
             (RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden)]
    parent_cell = load_parent_cell(parent, dev)
    shapes = []
    for batch, _, d_in, hidden in cases:
        x3, params = make_lstm(10 + len(shapes), batch, 2, d_in, hidden, 1, dev)
        p = params[0]
        x = x3[:, 0].contiguous()
        state = np.random.default_rng(50 + len(shapes)).standard_normal((2, batch, hidden))
        h = torch.tanh(torch.from_numpy(state[0].astype(np.float32))).to(dev)
        c = torch.from_numpy(state[1].astype(np.float32)).to(dev)
        args = (x, h, c, p["w"], p["u"], p["b"])
        errs = {}
        for impl in IMPLS:
            got = lstm_cell_fused(*args, impl=impl)
            want = lstm_cell_plain(*args, impl=impl)
            errs[impl] = max(compare(g, w, impl, TOL_F32, f"lstm_cell {batch, d_in, hidden}") for g, w in zip(got, want))
        # a tile that does not divide the batch
        got = lstm_cell_fused(*args, block_b=5)
        compare(got[0], lstm_cell_plain(*args)[0], "exact", TOL_F32, "lstm_cell block_b=5")
        parent_ms = parent_err = None
        if parent_cell is not None:
            parent_err = max(compare(g, w, "exact", TOL_F32, f"parent lstm_cell {batch, d_in, hidden}")
                             for g, w in zip(parent_cell(*args), lstm_cell_plain(*args)))
            parent_ms = device_ms(lambda: parent_cell(*args), uncounted=1)
        torch.cuda.synchronize()
        cell = torch.nn.LSTMCell(d_in, hidden, device=dev)
        with torch.no_grad():
            cell.weight_ih.copy_(p["w"].t()); cell.weight_hh.copy_(p["u"].t())
            cell.bias_ih.copy_(p["b"]); cell.bias_hh.zero_()
            lib_err = float((cell(x, (h, c))[0] - got[0]).abs().max())
            library_ms = time_ms(lambda: cell(x, (h, c)))
        out_bytes = 2 * nbytes(h)
        bound_ms, bound_by = bound(nbytes(*args) + out_bytes,
                                   lstm_flops(batch, 1, d_in, hidden))
        geometry = cell_plan("auto", batch, d_in, hidden)
        dev_ms = device_ms(lambda: lstm_cell_fused(*args))
        shapes.append({
            "shape": [batch, d_in, hidden], "units": geometry.units, "rows": geometry.rows,
            "grid": list(geometry.grid), "smem_bytes": geometry.smem_bytes,
            "max_abs_err": max(errs.values()),
            "err_by_impl": {k: r6(v) for k, v in errs.items()}, "tolerance": TOL_F32,
            "ms": r6(time_ms(lambda: lstm_cell_fused(*args))), "device_ms": r6(dev_ms),
            "parent_device_ms": r6(parent_ms), "parent_max_abs_err": r6(parent_err),
            "device_ms_over_parent": r6(None if parent_ms is None or dev_ms is None
                                        else dev_ms / parent_ms),
            "plain_ms": r6(time_ms(lambda: lstm_cell_plain(*args))),
            "library_ms": r6(library_ms), "library_max_abs_diff": r6(lib_err),
            "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    return entry("lstm_cell", "src/repro_torch/csrc/lstm_cell.cu",
                 "src/repro/kernels/lstm_cell.py:82", shapes)


def check_seq(dev, quantized: bool):
    lw = paper_workload()
    cases = [QUANT_SHAPE, (PAPER_BATCH, lw.seq, lw.d_in, lw.hidden), SCALED_SHAPE,
             (RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden)]
    tol = TOL_Q8 if quantized else TOL_F32
    name = "lstm_seq_q8" if quantized else "lstm_seq_f32"
    shapes = []
    for batch, seq, d_in, hidden in cases:
        x, params = make_lstm(20 + len(shapes), batch, seq, d_in, hidden, 1, dev)
        p = params[0]
        if quantized:
            qw = quantize_lstm_weights(p["w"], p["u"], p["b"], hidden)
            operands = (qw.w_q, qw.u_q, qw.b, qw.w_scale, qw.u_scale)
            kernel = lambda impl="exact", **kw: lstm_seq_fused_quantized(x, qw, impl=impl, **kw)
        else:
            operands = (p["w"], p["u"], p["b"], None, None)
            kernel = lambda impl="exact", **kw: lstm_seq_fused(x, p["w"], p["u"], p["b"],
                                                                impl=impl, **kw)
        errs = {}
        for impl in IMPLS:
            hs, (hn, cn) = kernel(impl, return_state=True)
            want = lstm_seq_plain(x, *operands, impl=impl, packed=quantized)
            errs[impl] = max(compare(g, w, impl, tol, f"{name} {batch, seq, d_in, hidden}")
                             for g, w in zip((hs, hn, cn), want))
        hs5 = kernel(block_b=5)  # a tile that does not divide the batch
        compare(hs5, lstm_seq_plain(x, *operands, packed=quantized)[0], "exact", tol,
                f"{name} block_b=5")
        slots = cluster_slots(dev)
        forced = chunked = None
        if (batch, seq, d_in, hidden) == QUANT_SHAPE:  # 7 rows a cluster: 5 x 7 + 5
            forced = plan_launch(RAGGED_TILE, batch, seq, d_in, hidden, quantized=quantized,
                                 slots=slots)
            if forced.path != "cluster" or forced.block_b != RAGGED_TILE:
                fail(f"{name}: block_b={RAGGED_TILE} planned {forced}, not {RAGGED_TILE} rows "
                     "a cluster")
            for impl in IMPLS:
                hs, (hn, cn) = kernel(impl, block_b=RAGGED_TILE, return_state=True)
                want = lstm_seq_plain(x, *operands, impl=impl, packed=quantized)
                errs[f"{impl}/block_b={RAGGED_TILE}"] = max(
                    compare(g, w, impl, tol, f"{name} block_b={RAGGED_TILE}")
                    for g, w in zip((hs, hn, cn), want))
            chunked, chunk_errs = check_seq_chunked(dev, quantized, tol)
            errs.update(chunk_errs)
        torch.cuda.synchronize()
        library_ms = lib_err = None
        if not quantized:
            lstm = torch.nn.LSTM(d_in, hidden, batch_first=True, device=dev)
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(p["w"].t()); lstm.weight_hh_l0.copy_(p["u"].t())
                lstm.bias_ih_l0.copy_(p["b"]); lstm.bias_hh_l0.zero_()
                lib_err = float((lstm(x)[0] - kernel()).abs().max())
                library_ms = time_ms(lambda: lstm(x))
        plan = plan_launch("auto", batch, seq, d_in, hidden, quantized=quantized, slots=slots)
        weights = [t for t in operands if t is not None]
        out_bytes = 4 * (batch * seq * hidden + 2 * batch * hidden)
        bound_ms, bound_by = bound(nbytes(x, *weights) + out_bytes,
                                   lstm_flops(batch, seq, d_in, hidden))
        dev_ms = device_ms(kernel)
        shapes.append({
            "shape": [batch, seq, d_in, hidden], **seq_plan(plan, quantized),
            "forced_ragged_plan": None if forced is None else seq_plan(forced, quantized),
            "chunked_plan": chunked,
            "max_abs_err": max(errs.values()),
            "err_by_impl": {k: r6(v) for k, v in errs.items()}, "tolerance": tol,
            "ms": r6(time_ms(kernel)), "device_ms": r6(dev_ms),
            "device_ms_per_step": r6(None if dev_ms is None else dev_ms / seq),
            "ms_by_impl": {impl: r6(time_ms(lambda: kernel(impl), reps=10, rounds=3))
                           for impl in IMPLS},
            "plain_ms": r6(time_ms(lambda: lstm_seq_plain(x, *operands, packed=quantized),
                                   reps=3, rounds=3)),
            "library_ms": r6(library_ms), "library_max_abs_diff": r6(lib_err),
            "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    out = entry(name, "src/repro_torch/csrc/lstm_seq.cu",
                "src/repro/kernels/lstm_seq.py:245", shapes)
    out["plan"] = {k: shapes[0][k] for k in ("path", "block_b", "cluster", "clusters", "chunk",
                                             "smem_bytes", "resident", "cluster_occupancy")}
    return out


def check_seq_chunked(dev, quantized: bool, tol: float):
    """K3 at ``CHUNK_SHAPE``, where the auto plan's input projection runs in
    chunks of steps (a chunk shorter than S, re-projected at every chunk's
    first step), held to its plain version at every impl."""
    batch, seq, d_in, hidden = CHUNK_SHAPE
    name = "lstm_seq_q8" if quantized else "lstm_seq_f32"
    plan = plan_launch("auto", batch, seq, d_in, hidden, quantized=quantized,
                       slots=cluster_slots(dev))
    if plan.path != "cluster" or plan.chunk >= seq:
        fail(f"{name} {CHUNK_SHAPE}: planned {plan}, not a cluster plan in chunks")
    x, params = make_lstm(29, batch, seq, d_in, hidden, 1, dev)
    p = params[0]
    if quantized:
        qw = quantize_lstm_weights(p["w"], p["u"], p["b"], hidden)
        operands = (qw.w_q, qw.u_q, qw.b, qw.w_scale, qw.u_scale)
        kernel = lambda impl: lstm_seq_fused_quantized(x, qw, impl=impl, return_state=True)
    else:
        operands = (p["w"], p["u"], p["b"], None, None)
        kernel = lambda impl: lstm_seq_fused(x, p["w"], p["u"], p["b"], impl=impl,
                                             return_state=True)
    errs = {}
    for impl in IMPLS:
        hs, (hn, cn) = kernel(impl)
        want = lstm_seq_plain(x, *operands, impl=impl, packed=quantized)
        errs[f"{impl}/{CHUNK_SHAPE}"] = max(
            compare(g, w, impl, tol, f"{name} {CHUNK_SHAPE} chunk={plan.chunk}")
            for g, w in zip((hs, hn, cn), want))
    return {"shape": list(CHUNK_SHAPE), **seq_plan(plan, quantized)}, errs


def seq_plan(plan, quantized: bool) -> dict:
    """A K3 or K4 launch plan as the kernels line reports it, with the number of
    its clusters the card holds at once (cudaOccupancyMaxActiveClusters)
    where it is a cluster plan."""
    occupancy = None
    if plan.path == "cluster":
        occupancy = runtime.query("repro_lstm_seq_cluster_occupancy", int(quantized),
                                  plan.block_b, plan.smem_bytes)
        if occupancy < 0:
            fail(f"cudaOccupancyMaxActiveClusters failed (CUDA error {-occupancy}) for {plan}")
    return {"path": plan.path, "block_b": plan.block_b, "cluster": plan.cluster,
            "clusters": plan.clusters, "chunk": plan.chunk, "smem_bytes": plan.smem_bytes,
            "resident": plan.resident, "cluster_occupancy": occupancy}


def stack_operands(params, quantized: bool):
    """The stack kernel's operands, a ``(w, u, b, sw, su)`` tuple a layer, as
    ``lstm_stack_fused`` builds them."""
    if quantized:
        return [(q.w_q, q.u_q, q.b, q.w_scale, q.u_scale) for q in quantize_lstm_stack(params)]
    return [(p["w"], p["u"], p["b"], None, None) for p in params]


def stack_kernel(x, operands, quantized: bool, block_b="auto"):
    """K4's wrapper on the kernel's own operands, impl="exact": int8 weights
    quantized once, as a deployment holds them (``lstm_stack_fused`` with
    ``quantized=True`` quantizes them again on every call)."""
    return _lstm_stack_call(x, operands, impl="exact", block_b=block_b, return_state=False,
                            packed=quantized)


def check_stack_case(dev, quantized: bool, shape, seed: int, block_b="auto", want_path=None,
                     chunked: bool = False) -> dict:
    """K4 at one (B, S, D, H, L) and ``block_b``, held to its plain version at
    every impl; its plan (and the card's occupancy for a cluster plan) and
    device time.  Fails if the plan is not ``want_path`` or, for
    ``chunked``, holds the whole projection at once."""
    batch, seq, d_in, hidden, layers = shape
    tol = TOL_Q8 if quantized else TOL_F32
    name = "lstm_stack_q8" if quantized else "lstm_stack_f32"
    plan = plan_launch(block_b, batch, seq, d_in, hidden, layers=layers, quantized=quantized,
                       slots=cluster_slots(dev))
    if (want_path and plan.path != want_path) or (chunked and plan.chunk >= seq):
        fail(f"{name} {shape} block_b={block_b}: planned {plan}")
    x, params = make_lstm(seed, batch, seq, d_in, hidden, layers, dev)
    operands = stack_operands(params, quantized)
    errs = {}
    for impl in IMPLS:
        hs, (hn, cn) = lstm_stack_fused(x, params, impl=impl, quantized=quantized,
                                        block_b=block_b, return_state=True)
        want = lstm_stack_plain(x, operands, impl=impl, packed=quantized)
        errs[impl] = max(compare(g, w, impl, tol, f"{name} {shape} block_b={block_b}")
                         for g, w in zip((hs, hn, cn), want))
    dev_ms = device_ms(lambda: stack_kernel(x, operands, quantized, block_b))
    return {"shape": list(shape), "requested_block_b": block_b, **seq_plan(plan, quantized),
            "max_abs_err": max(errs.values()), "err_by_impl": {k: r6(v) for k, v in errs.items()},
            "device_ms": r6(dev_ms),
            "device_ms_per_layer_step": r6(None if dev_ms is None else dev_ms / (seq * layers))}


# K4's cases on the cluster path beside its main shape: a forced tile that
# leaves a ragged last cluster (40 = 13 x 3 + 1), a batch whose projection
# runs in chunks of steps, and four layers at an odd S (the inter-layer
# buffers are reused two layers apart, and each mbarrier's phase count per
# layer is uneven)
STACK_RAGGED_TILE = 3
STACK_CHUNK_SHAPE = (200, 28, 256, 256, 3)
STACK_DEEP_SHAPE = (6, 11, 256, 256, 4)


def check_stack(dev, quantized: bool):
    lw = paper_workload()
    cases = [STACK_SHAPE, (PAPER_BATCH, lw.seq, lw.d_in, lw.hidden, 3),
             (RAGGED_BATCH, SCALED_SHAPE[1], SCALED_SHAPE[2], SCALED_SHAPE[3], 2)]
    tol = TOL_Q8 if quantized else TOL_F32
    name = "lstm_stack_q8" if quantized else "lstm_stack_f32"
    shapes = []
    for batch, seq, d_in, hidden, layers in cases:
        x, params = make_lstm(30 + len(shapes), batch, seq, d_in, hidden, layers, dev)
        operands = stack_operands(params, quantized)
        kernel = lambda impl="exact", **kw: lstm_stack_fused(x, params, impl=impl,
                                                              quantized=quantized, **kw)
        errs = {}
        for impl in IMPLS:
            hs, (hn, cn) = kernel(impl, return_state=True)
            want = lstm_stack_plain(x, operands, impl=impl, packed=quantized)
            errs[impl] = max(compare(g, w, impl, tol, f"{name} {batch, seq, d_in, hidden, layers}")
                             for g, w in zip((hs, hn, cn), want))
        hs3 = kernel(block_b=3)  # a tile that does not divide the batch
        compare(hs3, lstm_stack_plain(x, operands, packed=quantized)[0], "exact", tol,
                f"{name} block_b=3")
        more = []
        if (batch, seq, d_in, hidden, layers) == STACK_SHAPE:
            more = [check_stack_case(dev, quantized, STACK_SHAPE, 36, STACK_RAGGED_TILE,
                                     "cluster"),
                    check_stack_case(dev, quantized, STACK_CHUNK_SHAPE, 37, want_path="cluster",
                                     chunked=True),
                    check_stack_case(dev, quantized, STACK_DEEP_SHAPE, 38, want_path="cluster")]
            for case in more:
                errs[f"{case['requested_block_b']}/{tuple(case['shape'])}"] = case["max_abs_err"]
        torch.cuda.synchronize()
        library_ms = lib_err = None
        if not quantized:
            lstm = torch.nn.LSTM(d_in, hidden, num_layers=layers, batch_first=True, device=dev)
            with torch.no_grad():
                for l, p in enumerate(params):
                    getattr(lstm, f"weight_ih_l{l}").copy_(p["w"].t())
                    getattr(lstm, f"weight_hh_l{l}").copy_(p["u"].t())
                    getattr(lstm, f"bias_ih_l{l}").copy_(p["b"])
                    getattr(lstm, f"bias_hh_l{l}").zero_()
                lib_err = float((lstm(x)[0] - kernel()).abs().max())
                library_ms = time_ms(lambda: lstm(x))
        plan = plan_launch("auto", batch, seq, d_in, hidden, layers=layers, quantized=quantized,
                           slots=cluster_slots(dev))
        weights = [t for op in operands for t in op if t is not None]
        out_bytes = 4 * (batch * seq * hidden + 2 * layers * batch * hidden)
        bound_ms, bound_by = bound(nbytes(x, *weights) + out_bytes,
                                   lstm_flops(batch, seq, d_in, hidden, layers))
        timed = lambda: stack_kernel(x, operands, quantized)  # noqa: E731
        compare(timed(), lstm_stack_plain(x, operands, packed=quantized)[0], "exact", tol,
                f"{name} {batch, seq, d_in, hidden, layers} on its own operands")
        dev_ms = device_ms(timed)
        shapes.append({
            "shape": [batch, seq, d_in, hidden, layers], **seq_plan(plan, quantized),
            "more_cases": more or None, "max_abs_err": max(errs.values()),
            "err_by_impl": {k: r6(v) for k, v in errs.items()}, "tolerance": tol,
            "ms": r6(time_ms(timed)), "device_ms": r6(dev_ms),
            "device_ms_quantizing_per_call": r6(device_ms(kernel)) if quantized else None,
            "device_ms_per_layer_step": r6(None if dev_ms is None else dev_ms / (seq * layers)),
            "plain_ms": r6(time_ms(lambda: lstm_stack_plain(x, operands, packed=quantized),
                                   reps=2, rounds=3)),
            "library_ms": r6(library_ms), "library_max_abs_diff": r6(lib_err),
            "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    out = entry(name, "src/repro_torch/csrc/lstm_seq.cu",
                "src/repro/kernels/lstm_seq.py:368", shapes)
    out["plan"] = {k: shapes[0][k] for k in ("path", "block_b", "cluster", "clusters", "chunk",
                                             "smem_bytes", "resident", "cluster_occupancy")}
    return out


# ---------------------------------------------------------------------------
# The host path every wrapper shares
# ---------------------------------------------------------------------------
HOST_CALLS = 10_000   # calls per host-clock sample of the K1 split


def host_ns(fn, calls: int = HOST_CALLS) -> float:
    """Host nanoseconds per call of ``fn`` over ``calls`` calls in a loop
    (perf_counter_ns), after a warm-up; the card is synchronised around the
    loop, not inside it."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return elapsed / calls


def host_path(dev) -> dict:
    """Host time of each kernel wrapper at its smallest shape of this script:
    ``ms`` (CUDA events over a loop of calls: at these shapes the host's
    issue rate sets it) minus ``device_ms``; K2 also at its main-path shape.
    Then K1's host path at 40x28x256 f32 piece by piece, each piece timed
    alone by the host clock, beside ``torch.sigmoid`` on the same tensor."""
    lw = paper_workload()
    _, paper = make_lstm(60, 1, 1, lw.d_in, lw.hidden, 1, dev)
    p = paper[0]
    xs, _ = make_lstm(61, RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden, 1, dev)
    xc = xs[:, 0].contiguous()
    hc = torch.zeros((RAGGED_BATCH, lw.hidden), device=dev)
    xk, stack = make_lstm(62, PAPER_BATCH, lw.seq, lw.d_in, lw.hidden, 3, dev)
    b, s, _, h = QUANT_SHAPE
    x2, big = make_lstm(63, b, 1, h, h, 1, dev)
    x2 = x2[:, 0].contiguous()
    h2 = torch.zeros((b, h), device=dev)
    xq, wq, sx, sw = int8_operands(*INT8_TEST_SHAPES[2], dev, 64)
    fb, fh, fkv, fsq, fsk, fd = 1, 6, 3, 45, 77, 16
    gen = torch.Generator(device=dev).manual_seed(65)
    q = torch.randn((fb, fh, fsq, fd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((fb, fkv, fsk, fd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((fb, fkv, fsk, fd), generator=gen, device=dev).to(torch.bfloat16)
    xa = torch.randn((3, 33, 130), generator=gen, device=dev)
    wrappers = {
        "activation (3, 33, 130) f32": lambda: activation(xa),
        f"lstm_cell ({RAGGED_BATCH}, {lw.d_in}, {lw.hidden})":
            lambda: lstm_cell_fused(xc, hc, hc, p["w"], p["u"], p["b"]),
        f"lstm_cell {QUANT_SHAPE[0], QUANT_SHAPE[2], QUANT_SHAPE[3]} (main path)":
            lambda: lstm_cell_fused(x2, h2, h2, big[0]["w"], big[0]["u"], big[0]["b"]),
        f"lstm_seq ({RAGGED_BATCH}, {lw.seq}, {lw.d_in}, {lw.hidden}) f32":
            lambda: lstm_seq_fused(xs, p["w"], p["u"], p["b"]),
        f"lstm_stack ({PAPER_BATCH}, {lw.seq}, {lw.d_in}, {lw.hidden}, 3) f32":
            lambda: lstm_stack_fused(xk, stack),
        f"int8_matmul {INT8_TEST_SHAPES[2]}": lambda: int8_matmul(xq, wq, sx, sw),
        f"flash_attention {(fb, fh, fkv, fsq, fsk, fd)} bf16":
            lambda: flash_attention(q, k, v, causal=True),
    }
    per_wrapper = {}
    for name, fn in wrappers.items():
        ms, dms = time_ms(fn, reps=50), device_ms(fn)
        per_wrapper[name] = {"ms": r6(ms), "device_ms": r6(dms),
                             "host_us": r6(None if dms is None else (ms - dms) * 1e3),
                             "host_call_us": r6(host_ns(fn, 2000) / 1e3)}
    out = {"wrappers": per_wrapper}
    # "auto" (the tuner's pick, memoized per shape) against the same plan
    # passed explicitly: the host time the tuner adds to a call
    k3 = plan_launch("auto", RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden, slots=cluster_slots(dev),
                     backend=runtime.CUDA_BACKEND)
    k5 = plan(*INT8_TEST_SHAPES[2], "auto", "auto", "auto", runtime.CUDA_BACKEND)
    pairs = {
        f"lstm_seq ({RAGGED_BATCH}, {lw.seq}, {lw.d_in}, {lw.hidden}) f32": (
            lambda: lstm_seq_fused(xs, p["w"], p["u"], p["b"]),
            lambda: lstm_seq_fused(xs, p["w"], p["u"], p["b"], block_b=k3.block_b)),
        f"int8_matmul {INT8_TEST_SHAPES[2]}": (
            lambda: int8_matmul(xq, wq, sx, sw),
            lambda: int8_matmul(xq, wq, sx, sw, block_m=k5.block_m, block_n=k5.block_n,
                                block_k=k5.k_chunk)),
    }
    plans = {  # the plan lookup alone: what "auto" can add to a call
        f"lstm_seq ({RAGGED_BATCH}, {lw.seq}, {lw.d_in}, {lw.hidden}) f32": (
            lambda: plan_launch("auto", RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden,
                                slots=cluster_slots(dev), backend=runtime.CUDA_BACKEND),
            lambda: plan_launch(k3.block_b, RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden,
                                slots=cluster_slots(dev), backend=runtime.CUDA_BACKEND)),
        f"int8_matmul {INT8_TEST_SHAPES[2]}": (
            lambda: plan(*INT8_TEST_SHAPES[2], "auto", "auto", "auto", runtime.CUDA_BACKEND),
            lambda: plan(*INT8_TEST_SHAPES[2], k5.block_m, k5.block_n, k5.k_chunk,
                         runtime.CUDA_BACKEND)),
    }
    auto_vs = {}
    for name, (auto, explicit) in pairs.items():
        t = {"auto": [], "explicit": []}
        for _ in range(20):  # in turns; the best of twenty samples of each
            t["auto"].append(host_ns(auto, 500) / 1e3)
            t["explicit"].append(host_ns(explicit, 500) / 1e3)
        auto_us, explicit_us = min(t["auto"]), min(t["explicit"])
        lookup = {side: host_ns(fn, 20000) / 1e3 for side, fn in zip(("auto", "explicit"),
                                                                     plans[name])}
        auto_vs[name] = {"auto_call_us": r6(auto_us), "explicit_call_us": r6(explicit_us),
                         "auto_minus_explicit_us": r6(auto_us - explicit_us),
                         "plan_lookup_us": {k: r6(v) for k, v in lookup.items()}}
    out["auto_vs_explicit"] = auto_vs
    x = torch.randn(QUANT_SHAPE[:2] + QUANT_SHAPE[3:], device=dev)
    y = torch.empty_like(x)
    runtime.load_kernels()
    fn, pack, count = runtime._entries["repro_activation"]
    xp, yp, n = x.data_ptr(), y.data_ptr(), x.numel()
    raw, get_device = runtime._raw_stream, runtime._get_device
    pieces = {
        "wrapper": lambda: activation(x),
        "torch.sigmoid": lambda: torch.sigmoid(x),
        "torch.empty_like": lambda: torch.empty_like(x),
        "runtime.launch": lambda: runtime.launch("host_path", "repro_activation", 0, xp, yp, n,
                                                 0, 0, 0, 0),
        "pack + ctypes + C entry, no launch": lambda: fn(pack(xp, yp, 0, 0, 0, 0, 0, 0), count),
        "pack + ctypes + C entry + cudaLaunchKernel":
            lambda: fn(pack(xp, yp, n, 0, 0, 0, 0, raw(0)), count),
        "raw stream handle": lambda: raw(0),
        "current device": lambda: get_device(),
        "x.data_ptr()": lambda: x.data_ptr(),
        "x.is_contiguous()": lambda: x.is_contiguous(),
        "torch.cuda.current_stream().cuda_stream (the previous launch path)":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_device() (the previous launch path)": lambda: torch.cuda.current_device(),
    }
    split = {}
    for _ in range(2):  # the better of two samples of each piece
        for name, piece in pieces.items():
            t = host_ns(piece)
            split[name] = t if name not in split else min(split[name], t)
    split = {name: r6(t / 1e3) for name, t in split.items()}
    split["the wrapper's own Python (wrapper - empty_like - launch)"] = r6(
        split["wrapper"] - split["torch.empty_like"] - split["runtime.launch"])
    out["k1_split_us"] = split
    k1_ms, k1_library_ms = time_pair(lambda: activation(x), lambda: torch.sigmoid(x), reps=50)
    out.update(k1_ms=r6(k1_ms), k1_library_ms=r6(k1_library_ms),
               k1_over_library=r6(k1_ms / k1_library_ms))
    return out


# ---------------------------------------------------------------------------
# K5 int8_matmul and K6 flash_attention: kernel against plain version
# ---------------------------------------------------------------------------
GRANITE = "granite-3-8b"
SERVE_LAYERS = 8                    # the only cut of granite-3-8b: 40 → 8 layers
# (M, K, N): the reference's kernel tests, then every projection of the
# serving path at decode (M = 4 slots), a 64-token prefill and 4 x 64 tokens
INT8_TEST_SHAPES = [(64, 128, 64), (128, 256, 128), (32, 64, 96)]
INT8_PROJ_KN = [(4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096)]
INT8_MAIN = (4, 4096, 12800)        # the entry's own numbers: wg/wu at decode
# a ragged shape, and a split-K stress shape (ragged K and N, 17 chunks of K)
INT8_SHAPES = ([INT8_MAIN] + [(m, k, n) for m in (4, 64, 256) for k, n in INT8_PROJ_KN
                              if (m, k, n) != INT8_MAIN]
               + INT8_TEST_SHAPES + [(33, 4100, 1030), (4, 12803, 1030)])
# (B, H, KV, Sq, Sk, D, causal, dtype): granite-shaped causal attention over
# 2048 tokens, the reference's kernel tests in f32 and their bf16 twins (every
# head width, MQA non-causal, ragged 45 x 77), the reference's bf16 case, and
# a ragged non-causal case at the granite head width
_FLASH_TESTS = [(1, 4, 4, 128, 128, 32, True), (2, 8, 2, 128, 128, 64, True),
                (1, 4, 1, 64, 256, 32, False), (2, 2, 2, 256, 256, 16, True),
                (1, 6, 3, 45, 77, 16, True)]
FLASH_MAIN = (1, 32, 8, 2048, 2048, 128, True, torch.bfloat16)
FLASH_SHAPES = ([FLASH_MAIN, (1, 32, 8, 2048, 2048, 128, True, torch.float32)]
                + [(*c, torch.float32) for c in _FLASH_TESTS]
                + [(*c, torch.bfloat16) for c in _FLASH_TESTS]
                + [(1, 4, 2, 128, 128, 32, True, torch.bfloat16),
                   (1, 6, 3, 45, 77, 128, False, torch.bfloat16)])
# bf16 kernel against its plain version: the reference's bf16 flash
# tolerance, 3e-2.  Both round p to bf16 before p @ v and the output to bf16;
# they differ in the order of the f32 sums and in exp (exp2f(x log2 e) on the
# card), which can move p or an output across a bf16 rounding edge: one unit
# of 2^-8 relative, 3.9e-3 at |out| ~ 1 (seen on an H100).
TOL_BF16 = 3e-2


def int8_operands(m, k, n, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev)
    xq, sx = ops.quantize_rowwise(x)
    wq, sw = ops.quantize_colwise(w)
    return xq, wq, sx, sw


COLD_BYTES = 128 << 20  # weight copies cycled by cold_device_ms: over twice the 50 MB L2


def cold_device_ms(fn, wq):
    """Device time of one ``fn(w)`` over a ring of copies of ``wq`` whose
    bytes exceed the L2 cache, so that every call reads its weight from
    device memory, as the serving path does (its 1.6 GB of projections never
    fit L2).  ``device_ms`` of one weight in a loop finds it in L2 when it is
    smaller than 50 MB.  Device time, not CUDA-event time: back-to-back
    wrapper calls at decode are bound by the host."""
    copies = [wq] + [wq.clone() for _ in range(-(-COLD_BYTES // wq.numel()) - 1)]
    turn = iter(range(10**9))
    t = device_ms(lambda: fn(copies[next(turn) % len(copies)]), reps=len(copies))
    del copies
    return t


def int8_library_ok(m, k, n) -> bool:
    """torch._int_mm's shape rules on CUDA: more than 16 rows, K and N
    multiples of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


# (E, M, K, N, x shared by every product): the expert einsums of the MoE
# dense path, one launch over the expert axis.  granite-moe-3b-a800m at
# decode (M = 4 slots) and at a 4 x 64-token prefill, wg/wu (1536 x 512, the
# token block shared by the 48 experts, quantized once) and wd (512 x 1536,
# each expert's own rows); deepseek-v3 at decode, 256 experts of 7168 x 2048
# and 2048 x 7168.
INT8_BATCHED = [(48, 4, 1536, 512, True), (48, 4, 512, 1536, False),
                (48, 256, 1536, 512, True), (48, 256, 512, 1536, False),
                (256, 4, 7168, 2048, True), (256, 4, 2048, 7168, False)]


def batched_int8_operands(e, m, k, n, dev, seed, shared: bool):
    """E products' operands on the card, each weight quantized per expert;
    x is one product's expanded over the batch (stride 0) when ``shared``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(((1 if shared else e) * m, k), generator=gen, device=dev)
    xq, sx = ops.quantize_rowwise(x)
    xq, sx = xq.reshape(-1, m, k).expand(e, m, k), sx.reshape(-1, m, 1).expand(e, m, 1)
    wq = torch.empty((e, k, n), dtype=torch.int8, device=dev)
    sw = torch.empty((e, n), dtype=torch.float32, device=dev)
    for i in range(e):
        wq[i], sw[i] = ops.quantize_colwise(torch.randn((k, n), generator=gen, device=dev))
    return xq, wq, sx, sw


def check_int8_batched(dev, i: int, e: int, m: int, k: int, n: int, shared: bool) -> dict:
    """One batched shape: the kernel bit for bit against its plain version
    on two calls in a row (the split-K workspace of every product back at
    zero) and against E separate 2-D launches of the same kernel, and the
    device time of both with the weights read from device memory."""
    xq, wq, sx, sw = batched_int8_operands(e, m, k, n, dev, 400 + i, shared)
    got = int8_matmul(xq, wq, sx, sw)
    again = int8_matmul(xq, wq, sx, sw)
    want = int8_matmul_plain(xq, wq, sx, sw)
    torch.cuda.synchronize()
    separate = lambda w: [int8_matmul(xq[j], w[j], sx[j], sw[j]) for j in range(e)]  # noqa: E731
    one_by_one = torch.stack(separate(wq))
    for name, out in (("first call", got), ("second call", again),
                      ("E separate launches", one_by_one)):
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            fail(f"int8_matmul batch {(e, m, k, n)} {name}: not bit-identical to its plain "
                 f"version, max err {float((out - want).abs().max()):.3e}")
    del got, again, want, one_by_one
    x_bytes = (1 if shared else e) * m * k + 4 * (1 if shared else e) * m
    bound_ms, bound_by = bound(wq.numel() + 4 * sw.numel() + x_bytes + 4 * e * m * n,
                               2.0 * e * m * k * n, PEAK_INT8_OPS)
    out = {
        "shape": [m, k, n], "batch": e, "x_shared": shared, "max_abs_err": 0.0,
        "tolerance": 0.0,
        "plan": list(plan(m, k, n, "auto", "auto", "auto", runtime.CUDA_BACKEND, e)),
        "plan_of_one_product": list(plan(m, k, n, "auto", "auto", "auto",
                                         runtime.CUDA_BACKEND)),
        "ms": r6(time_ms(lambda: int8_matmul(xq, wq, sx, sw), reps=5, rounds=3)),
        "device_ms": r6(cold_device_ms(lambda w: int8_matmul(xq, w, sx, sw), wq)),
        "separate_launches_device_ms": r6(cold_device_ms(separate, wq)),
        "plain_ms": r6(time_ms(lambda: int8_matmul_plain(xq, wq, sx, sw), reps=2, rounds=3)),
        "library_ms": None, "bound_ms": r6(bound_ms), "bound_by": bound_by}
    del xq, wq, sx, sw
    torch.cuda.empty_cache()
    return out


def check_int8_matmul(dev):
    shapes = []
    for i, (m, k, n) in enumerate(INT8_SHAPES):
        xq, wq, sx, sw = int8_operands(m, k, n, dev, 100 + i)
        got = int8_matmul(xq, wq, sx, sw)
        again = int8_matmul(xq, wq, sx, sw)  # split-K counters and workspace were reset
        want = int8_matmul_plain(xq, wq, sx, sw)
        torch.cuda.synchronize()
        for name, out in (("first call", got), ("second call", again)):
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                fail(f"int8_matmul {(m, k, n)} {name}: not bit-identical to its plain version, "
                     f"max err {float((out - want).abs().max()):.3e}")
        library = lambda: (torch._int_mm(xq, wq).float() * sx) * sw[None, :]  # noqa: E731
        library_ms = time_ms(library) if int8_library_ok(m, k, n) else None
        bound_ms, bound_by = bound(nbytes(xq, wq, sx, sw) + 4 * m * n, 2.0 * m * k * n,
                                   PEAK_INT8_OPS)
        shapes.append({
            "shape": [m, k, n], "max_abs_err": 0.0,
            "plan": list(plan(m, k, n, "auto", "auto", "auto", runtime.CUDA_BACKEND)),
            "tolerance": 0.0,
            "ms": r6(time_ms(lambda: int8_matmul(xq, wq, sx, sw))),
            "cold_device_ms": r6(cold_device_ms(lambda w: int8_matmul(xq, w, sx, sw), wq)
                                 if (k, n) in INT8_PROJ_KN else None),
            "device_ms": r6(device_ms(lambda: int8_matmul(xq, wq, sx, sw))),
            "plain_ms": r6(time_ms(lambda: int8_matmul_plain(xq, wq, sx, sw), reps=5, rounds=3)),
            "library_ms": r6(library_ms), "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    # no PyTorch call computes a batch of int8 products with these scales
    # (torch._int_mm takes one 2-D product of more than 16 rows)
    shapes += [check_int8_batched(dev, i, *case) for i, case in enumerate(INT8_BATCHED)]
    return entry("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu",
                 "src/repro/kernels/int8_matmul.py:62", shapes)


@contextlib.contextmanager
def k5_shapes_recorded(seen: dict, path: str):
    """Within, every int8_matmul call the model code makes on the card
    (``qeinsum``, eager or while a CUDA graph is captured) records its
    shape in ``seen``: (E, M, K, N, x shared) → the paths that launched it,
    E = 0 for one 2-D product."""
    real = quant_mod.int8_matmul

    def recorded(xq, wq, sx, sw, **kw):
        if xq.is_cuda:
            e = xq.shape[0] if xq.dim() == 3 else 0
            shared = int(e > 1 and xq.stride(0) == 0)
            seen.setdefault((e, *xq.shape[-2:], wq.shape[-1], shared), set()).add(path)
        return real(xq, wq, sx, sw, **kw)

    quant_mod.int8_matmul = recorded
    try:
        yield
    finally:
        quant_mod.int8_matmul = real


def check_int8_path_shapes(dev, seen: dict) -> dict:
    """K5 at every shape the serving paths launched it at (``seen``, from
    :func:`k5_shapes_recorded`), bit for bit against its plain version on
    two calls in a row, from int8 operands over the whole range and random
    positive scales, x shared by the batch where the path shared it."""
    checked = []
    for i, key in enumerate(sorted(seen)):
        e, m, k, n, shared = key
        gen = torch.Generator(device=dev).manual_seed(600 + i)
        b = max(e, 1)
        xb = 1 if shared else b
        xq = torch.randint(-127, 128, (xb, m, k), generator=gen, device=dev, dtype=torch.int8)
        sx = torch.rand((xb, m, 1), generator=gen, device=dev) + 0.5
        wq = torch.randint(-127, 128, (b, k, n), generator=gen, device=dev, dtype=torch.int8)
        sw = torch.rand((b, n), generator=gen, device=dev) + 0.5
        operands = ((xq.expand(b, m, k), wq, sx.expand(b, m, 1), sw) if e
                    else (xq[0], wq[0], sx[0], sw[0]))
        want = int8_matmul_plain(*operands)
        for call in ("first call", "second call"):
            got = int8_matmul(*operands)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                fail(f"int8_matmul at the path's shape {key} ({sorted(seen[key])}), {call}: not "
                     f"bit-identical to its plain version, max err "
                     f"{float((got - want).abs().max()):.3e}")
        checked.append(list(key))
        del xq, sx, wq, sw, operands, want, got
    torch.cuda.empty_cache()
    return {"legend": "[E (0: one 2-D product), M, K, N, x shared by the batch]",
            "shapes": checked, "paths": sorted(set().union(*seen.values())),
            "calls_each": 2, "max_abs_err": 0.0, "tolerance": 0.0}


def check_quantize_on_card(dev) -> dict:
    """quantize_params' quantizer on the card gives the CPU's bytes for one
    full-width weight (granite-3-8b's wg, 4096 x 12800, bf16)."""
    gen = torch.Generator().manual_seed(7)
    w = (torch.randn((4096, 12800), generator=gen) / 64.0).to(torch.bfloat16)
    cpu = quantize_weight(w, lead=0, n_contract=1)
    card = quantize_weight(w.to(dev), lead=0, n_contract=1)
    same = (torch.equal(card.q.cpu(), cpu.q)
            and torch.equal(card.scale.cpu().view(torch.int32), cpu.scale.view(torch.int32)))
    if not same:
        fail("quantize_weight on the card differs from the CPU's bytes")
    return {"shape": [4096, 12800], "dtype": "bfloat16", "bytes_identical": True}


def flash_flops(b, h, sq, sk, d, causal) -> float:
    """Two products of 2 flops per multiply-add over the (query, key) pairs
    this run needs: with a causal mask, query i sees min(i + 1, Sk) keys."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return 4.0 * b * h * pairs * d


def check_flash(dev):
    shapes = []
    for i, (b, h, kv, sq, sk, d, causal, dtype) in enumerate(FLASH_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        err = compare(got, want, "exact", tol, f"flash_attention {(b, h, kv, sq, sk, d)}")
        torch.cuda.synchronize()
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
        lib_err = float((sdpa().float() - want.float()).abs().max())
        # the whole-row oracle keeps p in f32: in bf16 this is the error of
        # the kernel's bf16 p (a deliberate difference), held to the
        # reference's own bf16 tolerance against its oracle
        ref_err = compare(got, flash_attention_ref(q, k, v, causal=causal), "exact", tol,
                          f"flash_attention {(b, h, kv, sq, sk, d)} vs oracle")
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        bound_ms, bound_by = bound(nbytes(q, k, v) + nbytes(q),
                                   flash_flops(b, h, sq, sk, d, causal), peak)
        shapes.append({
            "shape": [b, h, kv, sq, sk, d], "causal": causal,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tolerance": tol,
            "ms": r6(time_ms(lambda: flash_attention(q, k, v, causal=causal), reps=10)),
            "device_ms": r6(device_ms(lambda: flash_attention(q, k, v, causal=causal), reps=5)),
            "plain_ms": r6(time_ms(lambda: flash_attention_plain(q, k, v, causal=causal),
                                   reps=3, rounds=3)),
            "library_ms": r6(time_ms(sdpa, reps=10)), "library_max_abs_diff": r6(lib_err),
            "oracle_max_abs_diff": r6(ref_err), "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    return entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:95", shapes)


def drive_flash_path(dev) -> dict:
    """K6's own path: its public op at the granite-shaped causal case."""
    b, h, kv, sq, sk, d, causal, dtype = FLASH_MAIN
    gen = torch.Generator(device=dev).manual_seed(300)
    q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if out.shape != q.shape or not bool(torch.isfinite(out.float()).all()):
        fail("ops.flash_attention: wrong shape or non-finite output")
    return {"expect": {"flash_attention": 1}}


# ---------------------------------------------------------------------------
# serve_dense: int8-weight serving of granite-3-8b at full width
# ---------------------------------------------------------------------------
GEN_PROMPTS, GEN_LEN, GEN_NEW = 4, 64, 8
SLOT_PROMPTS = (16, 33, 40, 64)     # the last one is admitted after two ticks
SLOT_BUDGET, SLOT_TICKS = 12, 10
AGREEMENT_FLOOR = 0.3               # docs/kernels.md: the wiring floor of int8 serving
# One decoder block on the card against the CPU, bf16, same weights.  The two
# sum bf16 products in other orders, so their roundings to bf16 (2^-8
# relative) differ here and there; the attention scores, rounded to bf16
# before the softmax, carry such a difference into every output of the row,
# and a last-bit difference can move an activation across a rounding edge of
# its int8 row quantization (one step of amax / 127).  Measured on an H100:
# max error 2.2% and mean 0.22% of the block's largest output.  Rule: max
# within 5e-2 and mean within 5e-3 of the largest output; a wrong weight
# layout, scale or mask is off by tens of percent.
BLOCK_TOL, BLOCK_MEAN_TOL = 5e-2, 5e-3


def standard_fan_in(params, cfg) -> None:
    """Rescale a freshly drawn model in place where its random weights make
    it chaotic, so that agreement with its bf16 twin measures the int8 path
    and not the chaos: :func:`attention_fan_in`, and on the ssm and hybrid
    families :func:`depth_scaled_mamba` and
    :func:`embedding_at_residual_scale` (``ssm_rescale_check.py`` measures
    each step on the card)."""
    attention_fan_in(params, cfg)
    depth_scaled_mamba(params)
    embedding_at_residual_scale(params)


def attention_fan_in(params, cfg) -> None:
    """The 3-D attention weights to std 1/sqrt(width of their contraction).
    The reference's fan-in rule (kept by ``init_model``) takes ``shape[-2]``
    of a 3-D weight: the head count as the fan-in of wq (32) and wk/wv (8),
    and the head width (128) as that of wo; at full width that makes every
    attention row nearly one-hot, so a random model is chaotic: one int8
    rounding flips the attended key and two greedy chains part at their
    first token (agreement 0.000 measured on an H100).  The same rule takes
    the head count (128) for MLA's wq_b, wk_b and wv_b, whose contraction is
    a rank r (1536, 512), and the value width for its wo (h x v).  Expert
    weights (E, d, f) are right already: ``shape[-2]`` is their contraction.
    zamba2's shared block is a GQA attention too (``params["shared"]["attn"]``,
    one weight set, not stacked); the Mamba2 layers' weights are 2-D, where
    the rule reads their contraction.  whisper has three GQA attentions, all
    rescaled: its encoder's and its decoder's self- and cross-attention.
    With the reference's draw its cross-attention is one-hot over the
    stub's 1500 frames, and on the card a last-bit difference between
    blocking and chunked prefill moved a query to another frame: the
    random-frames prefill's logits 30% apart (``agreement_check.py`` on an
    H100 80GB HBM3 at 700 W)."""
    d, h = cfg.d_model, cfg.num_heads
    if cfg.mla is None:
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        rules = (("wq", h, d), ("wk", kv, d), ("wv", kv, d), ("wo", hd, h * hd))
    else:
        m = cfg.mla
        rules = (("wq_b", h, m.q_lora_rank), ("wk_b", h, m.kv_lora_rank),
                 ("wv_b", h, m.kv_lora_rank), ("wo", m.v_head_dim, h * m.v_head_dim))
    attns = ([params["shared"]["attn"]] if "shared" in params else
             [params[s][a] for s in ("dense_blocks", "enc_blocks", "blocks") if s in params
              for a in ("attn", "self_attn", "cross_attn") if a in params[s]])
    for a in attns:
        for name, now, want in rules:
            a[name].mul_((now / want) ** 0.5)


def depth_scaled_mamba(params) -> None:
    """Each Mamba2 layer's projections (wz, wx, wB, wC, wdt, wo) times
    1/sqrt(l + 1), l its index in the stack (depth-scaled initialisation,
    Zhang, Titov & Sennrich 2019).  A random Mamba2 stack is chaotic: each
    block's gated product y * silu(z) doubles a relative perturbation of its
    input, and every later block re-amplifies what the earlier ones added,
    so the int8 path's rounding, a few percent a layer (the gate's output,
    int8-quantized by row before wo, has a largest entry ~12x its RMS),
    grows with depth.  Scaled, the first layers keep their size and later
    ones add less.  ``ssm_rescale_check.py`` on an H100 (80GB HBM3, 700 W):
    int8 against bf16, mamba2-780m's final hidden states 26% apart before
    and 5.6% after, zamba2-7b's 20% and 11.3%."""
    if "mamba" not in params.get("blocks", {}):
        return
    m = params["blocks"]["mamba"]
    depth = torch.arange(1, m["wo"].shape[0] + 1, dtype=torch.float32, device=m["wo"].device)
    for name in ("wz", "wx", "wB", "wC", "wdt", "wo"):
        m[name].mul_(depth.rsqrt().to(m[name].dtype)[:, None, None])


def embedding_at_residual_scale(params) -> None:
    """zamba2's (untied) and whisper's (tied) token embedding drawn at std 1
    in place of 0.02.  zamba2's shared block takes concat(x, x0), x0 the
    embedding, while the residual x it joins is of order 1: one int8 step of
    that row is larger than x0's entries, so the int8 engine's shared block
    loses the token identity it re-injects 14 times where the bf16 twin
    keeps it.  With it (``ssm_rescale_check.py``, same card): zamba2-7b's
    hidden states 4.6% apart, 87-92% of argmaxes kept.  whisper's decoder
    adds the embedding to a sinusoid of RMS 0.71: at 0.02 the tokens are a
    3% perturbation of the positions and every prompt's greedy chain is the
    same one token.  At std 1 the tokens reach the logits, but through the
    tied table: the residual holds the last token's row, so each chain
    repeats its prompt's last token (``serve_audio``'s ``distinct_tokens``
    says how many a run saw)."""
    if "shared" in params or "enc_blocks" in params:
        params["embed"]["tokens"].mul_(1 / 0.02)


def check_init_on_card(dev) -> dict:
    """The engine's own init on the card: weights drawn layer by layer from a
    CUDA generator and quantized as they are drawn.  Its peak memory must
    stay under what a full f32 copy of the projection stack alone would
    take."""
    cfg_q, _ = serve_configs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = engine_mod.InferenceEngine(cfg_q, sc=engine_mod.ServeConfig(max_batch=4, max_len=128),
                                     seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    proj = sum(t.q.numel() for t in _quant_leaves(eng.params))
    f32_stack = 4 * proj
    if peak >= f32_stack:
        fail(f"init_on_card: peak {peak} bytes, not under an f32 copy of the stack ({f32_stack})")
    del eng
    torch.cuda.empty_cache()
    return {"seconds": r6(seconds), "peak_bytes": peak, "int8_projection_bytes": proj,
            "f32_projection_stack_bytes": f32_stack}


def k5_per_call(cfg, kind: str) -> int:
    """int8_matmul launches of one model call (``prefill``, ``decode_step``,
    ``prefill_chunk`` or ``decode_verify``), from the code: 7 a layer for
    granite-3-8b and granite-moe (wq, wk, wv, wo, then wg, wu, wd, each of
    granite-moe's three expert einsums ONE launch over all 48 experts; the
    router is a plain f32 product).  deepseek's MLA makes 6 at prefill
    (wq_a, wq_b, wkv_a, wk_b and wv_b decompressing K/V, wo) and 4 at decode
    and chunk (the absorbed wk_b and wv_b contract over non-leading axes and
    go through dequantize, as in the reference); its dense MLP 3; its MoE 3
    expert launches + 3 of the shared expert.  A Mamba2 layer makes 3 (wz, wx,
    wo; wB, wC and wdt are plain products) and an application of zamba2's
    shared block 9 (w_in, wq, wk, wv, wo, wg, wu, wd, w_out): 144 a call for
    mamba2-780m, 243 + 14 x 9 = 369 for zamba2-7b.  whisper's encoder makes 6
    a layer (wq, wk, wv, wo, wi, wo), its decoder 10 a layer at prefill (self
    wq, wk, wv, wo; cross wq, wk and wv over the encoder output, wo; wi, wo)
    and 8 at decode, chunk and verify, whose cross K/V are the cache's;
    ``encoder_cross_cache`` the encoder's and 2 a decoder layer (cross wk,
    wv): 64 / 32 / 32 for whisper-tiny."""
    if cfg.family == "audio":
        enc, dec = 6 * cfg.encoder_layers, cfg.num_layers
        return {"prefill": enc + 10 * dec, "encoder_cross_cache": enc + 2 * dec}.get(
            kind, 8 * dec)
    if cfg.family in ("ssm", "hybrid"):
        apps = math.ceil(cfg.num_layers / cfg.attn_every) if cfg.family == "hybrid" else 0
        return 3 * cfg.num_layers + 9 * apps
    if cfg.mla is None:
        return 7 * cfg.num_layers
    attn = 6 if kind == "prefill" else 4
    k = cfg.first_k_dense
    return k * (attn + 3) + (cfg.num_layers - k) * (attn + 6)


class CallLog:
    """Wraps model functions the engine calls (``prefill``, ``decode_step``,
    ``prefill_chunk``, ``decode_verify``, and whisper's
    ``encoder_cross_cache``): each call is synchronised and timed, its
    int8_matmul launches counted against ``k5_per_call`` of its config, its
    logits (the cross K/V of ``encoder_cross_cache``) kept and checked
    finite.  A call made while a CUDA
    graph is being captured runs nothing and passes through unlogged."""

    def __init__(self):
        self.calls: list[dict] = []

    def wrap(self, kind, fn):
        def call(*args, **kw):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kw)
            torch.cuda.synchronize()
            before = runtime.launch_counts().get("int8_matmul", 0)
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kw)
            torch.cuda.synchronize()
            cfg = next(a for a in (*args, *kw.values()) if isinstance(a, ArchConfig))
            self.calls.append({
                "kind": kind, "ms": (time.perf_counter() - t0) * 1e3,
                "int8_matmul": runtime.launch_counts().get("int8_matmul", 0) - before,
                "per_call": k5_per_call(cfg, kind) if cfg.quant == "int8" else 0,
                "finite": bool(torch.isfinite(logits).all()),
                "rows": int(logits.shape[0]), "logits": logits})
            return logits, cache
        return call

    def check(self, what: str) -> None:
        for c in self.calls:
            if c["int8_matmul"] != c["per_call"]:
                fail(f"{what}: a {c['kind']} call launched int8_matmul {c['int8_matmul']} "
                     f"times, {c['per_call']} expected (k5_per_call)")
            if not c["finite"]:
                fail(f"{what}: non-finite logits in a {c['kind']} call")

    def __enter__(self):
        self.real = {name: getattr(engine_mod, name) for name in
                     ("prefill", "decode_step", "prefill_chunk", "decode_verify",
                      "encoder_cross_cache")}
        for name, fn in self.real.items():
            setattr(engine_mod, name, self.wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(engine_mod, name, fn)


def serve_configs():
    cfg = dataclasses.replace(get_config(GRANITE), num_layers=SERVE_LAYERS)
    return dataclasses.replace(cfg, quant="int8"), cfg


def image_rows(eng) -> int:
    """Positions a prompt of the vision-language model gives its image: the
    ``frontend_seq`` patch rows of the engine's front-end stub take the
    place of its first tokens, so every prompt of the serving helpers is
    that much longer (256 image positions, then the text); 0 otherwise."""
    return eng.cfg.frontend_seq if eng.cfg.frontend == "vision" else 0


def slot_path(eng, rng):
    """A slot pool of 4: prompts of ``SLOT_PROMPTS`` tokens (after the image
    rows, :func:`image_rows`) admitted at tick 0 (the last at tick 2),
    ``SLOT_TICKS`` masked decode ticks (the first captures the graph, the
    others replay it), each slot retired at its budget.  Returns (pool,
    tokens by slot, tick ms, every live slot finite)."""
    vocab, lead = eng.cfg.vocab_size, image_rows(eng)
    pool = eng.make_pool()
    slot_tokens = {s: [] for s in range(len(SLOT_PROMPTS))}
    slot_finite, tick_ms = True, []
    for tick in range(SLOT_TICKS):
        if tick == 0:
            for s, n in enumerate(SLOT_PROMPTS[:-1]):
                p = rng.integers(0, vocab, lead + n).astype(np.int32)
                slot_tokens[s].append(eng.prefill_into_slot(pool, s, p, rid=s,
                                                            budget=SLOT_BUDGET))
        if tick == 2:
            s = len(SLOT_PROMPTS) - 1
            p = rng.integers(0, vocab, lead + SLOT_PROMPTS[s]).astype(np.int32)
            slot_tokens[s].append(eng.prefill_into_slot(pool, s, p, rid=s, budget=SLOT_BUDGET))
        live = pool.decode_mask().copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, fin = eng.masked_decode_step(pool)  # the first tick captures the graph
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        slot_finite = slot_finite and bool(fin[live].all())
        for s in map(int, np.flatnonzero(live)):
            pool.advance(s, 1, int(nxt[s]))
            slot_tokens[s].append(int(nxt[s]))
            if pool.slots[s].emitted >= pool.slots[s].budget:
                pool.retire(s)
    return pool, slot_tokens, tick_ms, slot_finite


def drive_serve_dense(dev) -> dict:
    """generate and the slot path through the int8 engine; the full-precision
    engine on the same weights for greedy-chain agreement."""
    cfg_q, cfg_f = serve_configs()
    sc = engine_mod.ServeConfig(max_batch=4, max_len=128)
    params = init_model(cfg_f, torch.Generator(device=dev).manual_seed(0), dev)
    standard_fan_in(params, cfg_f)
    t0 = time.perf_counter()
    eng = engine_mod.InferenceEngine(cfg_q, params=params, sc=sc)  # quantizes at init
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.q.numel() for t in _quant_leaves(eng.params))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg_q.vocab_size, (GEN_PROMPTS, GEN_LEN)).astype(np.int32)

    with CallLog() as log:
        t0 = time.perf_counter()
        tokens_q = eng.generate(prompts, GEN_NEW)
        generate_s = time.perf_counter() - t0
        n_generate = len(log.calls)
        pool, slot_tokens, tick_ms, slot_finite = slot_path(eng, rng)
    log.check("serve_dense")
    per_call = 7 * cfg_q.num_layers
    graph = eng.step_graphs(pool)[("decode", 0)]
    if graph.launches.get("int8_matmul") != per_call or graph.replays != SLOT_TICKS:
        fail(f"serve_dense: the decode graph holds {graph.launches} launches and was "
             f"replayed {graph.replays} times ({per_call} int8_matmul, {SLOT_TICKS} expected)")
    if not slot_finite:
        fail("serve_dense: masked_decode_step flagged a live slot non-finite")
    if tokens_q.shape != (GEN_PROMPTS, GEN_NEW):
        fail(f"serve_dense: generate returned {tokens_q.shape}")

    # the same engine without quantization, on the same weights
    full = engine_mod.InferenceEngine(cfg_f, params=params, sc=sc)
    tokens_f = full.generate(prompts, GEN_NEW)
    agreement = float((tokens_q == tokens_f).mean())
    if agreement < AGREEMENT_FLOOR:
        fail(f"serve_dense: greedy-chain agreement {agreement:.3f} with the full-precision "
             f"engine, under the floor {AGREEMENT_FLOOR}")
    del full
    gen_calls = log.calls[:n_generate]
    decode_ms = [c["ms"] for c in gen_calls if c["kind"] == "decode_step"]
    slot_prefill_ms = [c["ms"] for c in log.calls[n_generate:] if c["kind"] == "prefill"]
    report = {
        "arch": GRANITE, "layers": cfg_q.num_layers, "of_layers": get_config(GRANITE).num_layers,
        "dtype": "bfloat16", "quant": "int8", "int8_weight_bytes": weight_bytes,
        "quantize_at_init_s": r6(init_s), "generate": {
            "prompts": GEN_PROMPTS, "prompt_len": GEN_LEN, "new_tokens": GEN_NEW,
            "seconds": r6(generate_s), "prefill_ms": r6(gen_calls[0]["ms"]),
            "decode_ms_median": r6(statistics.median(decode_ms)),
            "decode_ms": [r6(t) for t in decode_ms]},
        "slots": {"max_batch": 4, "max_len": 128, "prompts": list(SLOT_PROMPTS),
                  "prefill_ms": [r6(t) for t in slot_prefill_ms],
                  "tick_ms_median": r6(statistics.median(tick_ms[1:])),
                  "tick_ms": [r6(t) for t in tick_ms], "tokens": slot_tokens},
        "calls": len(log.calls), "graph_replays": graph.replays,
        "int8_matmul_per_call": per_call,
        "greedy_agreement_vs_full_precision": r6(agreement),
        "agreement_floor": AGREEMENT_FLOOR,
    }
    # the first tick's warm-up is a logged call; replays run the captured launches
    return {"expect": {"int8_matmul": per_call * (len(log.calls) + graph.replays)},
            "report": report, "engine": eng}


def profile_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA, a trace
    holding every launched kernel, ``profiled``): wall time, device-busy time
    (the kernels' own device time; the operators that launched them are not
    counted again), the idle share, and the device time of int8_matmul and of
    the largest other kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    sample = profiled(fn, activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if sample is None:
        fail("profile: no trace held every kernel the call launched")
    prof, wall_ms = sample
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                       key=lambda t: -t[1])
    busy = sum(t for _, t, _ in by_kernel)
    k5 = [(t, c) for k, t, c in by_kernel if "int8_matmul_kernel" in k]
    # first kernel start to last kernel end: span - busy is the device's idle
    # time between the call's kernels, wall - span the host's share around them
    kernels = [e.time_range for e in prof.events() if e.device_type == DeviceType.CUDA]
    span = (max(r.end for r in kernels) - min(r.start for r in kernels)) / 1e3
    return {"wall_ms": r6(wall_ms), "device_busy_ms": r6(busy), "device_span_ms": r6(span),
            "idle_share": r6(1.0 - busy / wall_ms) if wall_ms else None,
            "int8_matmul_device_ms": r6(sum(t for t, _ in k5)),
            "int8_matmul_events": sum(c for _, c in k5),
            "port_kernel_events": port_kernel_events(prof),
            "device_launches": sum(c for _, _, c in by_kernel),
            "top_kernels_ms": [[k[:60], r6(t), c] for k, t, c in by_kernel[:6]]}


def profile_serve(eng, dev) -> dict:
    """Where a call's time goes: one prefill of the generate workload
    (``generate(prompts, 1)``: prefill + one decode) and one decode tick of
    4 live slots (a replayed graph), each under ``torch.profiler``."""
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, eng.cfg.vocab_size, (GEN_PROMPTS, GEN_LEN)).astype(np.int32)
    pool = eng.make_pool()
    for s, n in enumerate(SLOT_PROMPTS):
        p = rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32)
        eng.prefill_into_slot(pool, s, p, rid=s, budget=SLOT_BUDGET)
    return {"generate_1": profile_call(lambda: eng.generate(prompts, 1)),
            "decode_tick_4_slots": profile_call(lambda: eng.masked_decode_step(pool))}


# ---------------------------------------------------------------------------
# serve_engine: the rest of the contiguous engine at full width, the decode
# and verify ticks replayed as CUDA graphs
# ---------------------------------------------------------------------------
ENGINE_SC = {"max_batch": 4, "max_len": 128, "spec_slack": 4}
GROUP_LEN, CHUNK_TOKENS = 64, 16    # a group of 2 prompts of 64 tokens, in chunks of 16
DECODING_PROMPTS = (24, 40)         # slots 2 and 3 decode while the group prefills
SPEC_K = 4
SPEC_PROMPTS = (16, 33, 40, 25)
CHAIN_TICKS = 16                    # the plain chain the verify windows are taken from
FORCED_TICKS = 3                    # teacher-forced verify ticks: 3 x 4 slots x 5 positions
VERIFY_AGREEMENT = 0.95             # per-position argmax agreement, verify vs plain decode
# A verify position whose token differs from plain decode's must be a near
# tie of the plain chain's own logits: its margin between the two tokens at
# most VERIFY_TIE of the largest |logit|.  And no position's logits may differ
# from plain decode's by more than VERIFY_LOGIT_DIFF of the largest |logit|:
# a window scored at the wrong positions or over the wrong rows moves them by
# their own size.  (Read on an H100 80GB HBM3 at 700 W: flips at margins
# 0-0.015; largest differences 0.017 granite-3-8b, 0.032 granite-moe, 0.082
# deepseek-v3.)
VERIFY_TIE = 0.05
VERIFY_LOGIT_DIFF = 0.25
TIMED_TICKS = 15                    # unprofiled ticks a kind, replayed and eager in turns
ENGINE_BUDGET = 40


def decode_chain(eng, pool, chains: dict, ticks: int, what: str, logits: list | None = None
                 ) -> None:
    """``ticks`` masked-decode ticks; every decoding slot's token is committed
    and appended to its chain, and each tick's logits (B, V) to ``logits``
    when it is given."""
    for _ in range(ticks):
        live = pool.decode_mask().copy()
        nxt, fin = eng.masked_decode_step(pool)
        if not fin[live].all():
            fail(f"{what}: a decoding slot read non-finite")
        if logits is not None:
            out = eng.step_graphs(pool)[("decode", 0)].outputs["logits"]
            logits.append(out[:, :eng.cfg.vocab_size].float().cpu())
        for s in map(int, np.flatnonzero(live)):
            pool.advance(s, 1, int(nxt[s]))
            chains[s].append(int(nxt[s]))


def host_accepted(drafts, tokens) -> np.ndarray:
    """Greedy prefix acceptance recomputed on the host."""
    return np.cumprod(drafts == tokens[:, :-1], axis=1).sum(axis=1)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def graph_vs_eager(g, what: str, **inputs) -> dict:
    """One replay of graph ``g`` and the same step run eagerly on a copy of
    its cache, from the same inputs: every output and the caches after must
    be the same bits, and K5's split-K workspace of the capture stream must
    be back at zero."""
    g.load(**inputs)
    copy = {k: v.clone() for k, v in g.cache.items()}
    replayed = {k: v.clone() for k, v in g.replay().items()}
    eager = g.eager(copy)
    torch.cuda.synchronize()
    for name, out in replayed.items():
        if not same_bits(out, eager[name]):
            fail(f"{what}: the replayed tick's {name} differs from the eager tick's")
    for key, t in copy.items():
        if not same_bits(t, g.cache[key]):
            fail(f"{what}: the replayed tick's cache {key!r} differs from the eager tick's")
    ws, cnt = int8_mod._workspaces[(g.device.index, g.stream.cuda_stream)]
    if ws.any() or cnt.any():
        fail(f"{what}: K5's split-K workspace is not back at zero after a replay")
    return {"outputs_bitwise_equal": sorted(replayed), "cache_bitwise_equal": True,
            "workspace_zero": True, "launches_a_replay": g.launches}


def forced_verify(eng, vpool, chain: dict, chain_logits: list, what: str
                  ) -> tuple[dict, np.ndarray]:
    """``FORCED_TICKS`` verify ticks of the four slots of ``vpool`` (prefilled
    as the plain ``chain`` was), the drafts teacher-forced from the chain,
    then one tick of always-wrong drafts, which must accept none.  The
    per-position argmax agreement with the chain must reach
    ``VERIFY_AGREEMENT`` (``MOE_VERIFY_FLOOR`` for the moe family and the
    vision-language model) over at
    least 32 positions.  Each position's logits are held against the
    chain's (``chain_logits``, one (B, V) a tick): their largest difference
    at most ``VERIFY_LOGIT_DIFF``, and where the tokens differ the chain's
    own margin between the two at most ``VERIFY_TIE``, of the largest
    |logit|.
    On the moe family the ticks with such flips are run again eagerly with
    the router recorded (:func:`flip_routes`).  Returns the report and the
    last tick's drafts."""
    vocab, routes = eng.cfg.vocab_size, eng.cfg.moe is not None
    floor = MOE_VERIFY_FLOOR if routes or eng.cfg.family == "vlm" else VERIFY_AGREEMENT
    agree = positions = 0
    worst, flips, route_reports = 0.0, [], []
    for tick in range(FORCED_TICKS + 1):
        es = [vpool.slots[s].emitted for s in range(4)]  # a slot that flipped is behind
        n = min(SPEC_K + 1, *(len(chain[s]) - e for s, e in enumerate(es)))
        want = np.asarray([chain[s][e:e + n] for s, e in enumerate(es)])
        drafts = want[:, :SPEC_K].astype(np.int32)
        if tick == FORCED_TICKS:  # always wrong: the first draft is not the plain token
            drafts = ((want[:, :1] + 1 + np.arange(SPEC_K)) % vocab).astype(np.int32)
        before = ({k: v.clone() for k, v in vpool.cache.items()}, vpool.tok.copy(),
                  vpool.positions().copy()) if routes else None
        toks, acc, fin = eng.masked_speculative_step(vpool, drafts)
        if not fin.all() or not (acc == host_accepted(drafts, toks)).all():
            fail(f"{what}: verify tick {tick}: finite {fin}, accepted {acc}")
        n = min(want.shape[1], toks.shape[1])
        agree += int((toks[:, :n] == want[:, :n]).sum())
        positions += want[:, :n].size
        lv = eng.step_graphs(vpool)[("verify", SPEC_K)].outputs["logits"][..., :vocab].float().cpu()
        tick_flips = []
        for s in range(4):
            for j in range(n):
                ld = chain_logits[es[s] + j - 1][s]  # decode tick e + j gave chain[s][e + j]
                scale = float(ld.abs().max())
                worst = max(worst, float((lv[s, j] - ld).abs().max()) / scale)
                a, b = int(want[s, j]), int(toks[s, j])
                if a != b:
                    tick_flips.append({"tick": tick, "slot": s, "j": j, "chain": a, "verify": b,
                                       "chain_margin_rel": r6(float(ld[a] - ld[b]) / scale)})
        if routes and tick_flips:
            route_reports.append(flip_routes(eng, *before, drafts, tick_flips))
        flips += tick_flips
        if tick < FORCED_TICKS:  # each slot commits its accepted drafts, then the chain's token
            for s in range(4):
                a = int(acc[s])
                vpool.advance(s, a + 1, chain[s][es[s] + a])
        elif acc.any():
            fail(f"{what}: always-wrong drafts accepted {acc}")
    agreement = agree / positions
    report = {"k": SPEC_K, "positions": positions, "per_position_agreement": r6(agreement),
              "floor": floor, "always_wrong_accepted": acc.tolist(),
              "logits_max_abs_diff_rel": r6(worst), "logits_diff_limit": VERIFY_LOGIT_DIFF,
              "flips": flips, "flip_margin_limit": VERIFY_TIE}
    if routes:
        report["flip_routes"] = route_reports
    if positions < 32 or agreement < floor:
        fail(f"{what}: verify agrees with plain decode at {agreement:.3f} of {positions} "
             f"positions (floor {floor} over >= 32): {json.dumps(report)}")
    if worst > VERIFY_LOGIT_DIFF or any(f["chain_margin_rel"] > VERIFY_TIE for f in flips):
        fail(f"{what}: verify's logits differ from plain decode's by {worst:.3f} (limit "
             f"{VERIFY_LOGIT_DIFF}), or a flip is no near tie (limit {VERIFY_TIE}): "
             f"{json.dumps(report)}")
    return report, drafts


def routed(fn):
    """``fn()`` with the MoE router recording each of its calls (one a MoE
    layer): every token's expert set and the gap between the probability of
    the last expert it takes and of the first it leaves."""
    calls, real = [], moe_mod._router

    def recording(params, x2d, cfg):
        w, ids, probs = real(params, x2d, cfg)
        edge = torch.sort(probs, dim=-1, descending=True).values[:, cfg.moe.top_k - 1:
                                                                  cfg.moe.top_k + 1]
        calls.append((ids.sort(dim=-1).values.cpu(), (edge[:, 0] - edge[:, 1]).cpu()))
        return w, ids, probs

    moe_mod._router = recording
    try:
        return fn(), calls
    finally:
        moe_mod._router = real


def flip_routes(eng, cache, tok, pos, drafts, flips) -> dict:
    """One verify tick whose tokens differ from plain decode, run again
    eagerly from a copy of its cache: the verify window, and the same K+1
    inputs decoded one at a time from another copy, the router recorded in
    both (launches recorded apart: a diagnosis, not the path).  For every
    token, the MoE layers whose expert set differs between the two, and the
    router's gap there; for each flip, the eager runs' tokens."""
    cfg, dev, k = eng.cfg, eng.device, drafts.shape[1]
    tokens = torch.as_tensor(np.concatenate([tok[:, None], drafts], 1).astype(np.int64),
                             device=dev)
    p = torch.as_tensor(pos.astype(np.int64), device=dev)
    with runtime.launches_recorded(), torch.inference_mode():
        copy = {n: t.clone() for n, t in cache.items()}
        (vlog, _), vcalls = routed(lambda: model_mod.decode_verify(eng.params, copy, tokens, p, cfg))
        copy = {n: t.clone() for n, t in cache.items()}
        steps = [routed(lambda j=j: model_mod.decode_step(eng.params, copy, tokens[:, j:j + 1],
                                                          p + j, cfg)) for j in range(k + 1)]
    vocab = cfg.vocab_size
    differ = []  # (slot, j, layer, verify's gap, decode's gap) where the expert sets differ
    for j, ((_, _), dcalls) in enumerate(steps):
        for layer, ((vid, vgap), (did, dgap)) in enumerate(zip(vcalls, dcalls)):
            for s in range(tok.shape[0]):
                r = s * (k + 1) + j
                if not torch.equal(vid[r], did[s]):
                    differ.append([s, j, layer, r6(float(vgap[r])), r6(float(dgap[s]))])
    out = {"tick": flips[0]["tick"], "moe_layers": len(vcalls), "tokens": tok.shape[0] * (k + 1),
           "expert_sets_differ": differ, "flips": []}
    for f in flips:
        s, j = f["slot"], f["j"]
        out["flips"].append({
            "slot": s, "j": j, "eager_verify": int(vlog[s, j, :vocab].argmax()),
            "eager_decode": int(steps[j][0][0][s, :vocab].argmax()),
            "layers_differ": [d[2] for d in differ if d[0] == s and d[1] == j]})
    return out


def strict_identity(dev, arch: str = GRANITE, quant: str | None = "int8") -> tuple[dict, list]:
    """The reduced config of ``arch`` of the CPU tests, in f32 (with int8
    weights unless ``quant`` is None), on the card: chunked prefill against
    blocking prefill, and speculative verify (oracle drafts in one slot,
    always-wrong in the other) against plain decode.  Tokens must be
    identical.  MLA with int8 weights skips the first: its blocking prefill
    decompresses K/V through int8 ``wk_b`` / ``wv_b`` (c row-quantized)
    where its chunk step contracts with the dequantized weights, as in the
    reference, so the two agree to quantization noise only (the reference
    claims that identity in f32 without int8, ``tests/test_serving.py``).
    Verify and decode both take the absorbed path: speculative == plain
    holds with int8 weights too."""
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32, quant=quant)
    chunked = quant is None or cfg.mla is None
    # f32 weights, as the CPU tests carry them (init_model draws bf16 leaves)
    params = tree_map(lambda t: t.float(), init_model(cfg, torch.Generator(dev).manual_seed(0),
                                                      dev))
    eng = engine_mod.InferenceEngine(
        cfg, params=params, sc=engine_mod.ServeConfig(max_batch=3, max_len=48, spec_slack=SPEC_K))
    prompts = np.random.default_rng(41).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    pools = [eng.make_pool() for _ in range(3)]
    block = {j: [eng.prefill_into_slot(pools[0], j, prompts[j], rid=j, budget=10)]
             for j in range(2)}
    decode_chain(eng, pools[0], block, 6, "strict identity")
    if chunked:
        st = eng.begin_chunked_prefill(pools[1], [0, 1], prompts, rids=[0, 1], budgets=[10, 10])
        while not st.done:
            eng.chunked_prefill_step(st, 4)
        chunk = {j: [int(t)] for j, t in enumerate(eng.finish_chunked_prefill(pools[1], st))}
        decode_chain(eng, pools[1], chunk, 6, "strict identity")
        if chunk != block:
            fail(f"strict identity: chunked prefill {chunk} != blocking {block}")
    ref, pool = block[0], pools[2]
    good = [eng.prefill_into_slot(pool, 0, prompts[0], rid=0, budget=len(ref))]
    bad = [eng.prefill_into_slot(pool, 1, prompts[0], rid=1, budget=len(ref))]
    ticks = 0
    while len(bad) < len(ref):
        drafts = np.zeros((3, SPEC_K), np.int32)
        drafts[0] = (ref[len(good):len(good) + SPEC_K] + [0] * SPEC_K)[:SPEC_K]
        drafts[1] = [(t + 1) % cfg.vocab_size for t in
                     (ref[len(bad):len(bad) + SPEC_K] + [0] * SPEC_K)[:SPEC_K]]
        out, acc, fin = eng.masked_speculative_step(pool, drafts)
        ticks += 1
        if not fin[:2].all() or acc[1] != 0:
            fail(f"strict identity: verify tick {ticks}: finite {fin}, accepted {acc}")
        if len(good) < len(ref):
            n = min(int(acc[0]) + 1, len(ref) - len(good))
            good.extend(out[0, :n].tolist())
            pool.advance(0, n, int(out[0, n - 1]))
        bad.append(int(out[1, 0]))
        pool.advance(1, 1, int(out[1, 0]))
    if good != ref or bad != ref:
        fail(f"strict identity: speculative {good} / {bad} != plain decode {ref}")
    graphs = [g for p in pools for g in eng.step_graphs(p).values()]
    return {"config": cfg.name, "dtype": "float32", "quant": quant,
            "layers": cfg.num_layers, "tokens": ref, "verify_ticks": ticks,
            "chunked_equals_blocking": True if chunked else "not run",
            "speculative_equals_plain": True}, graphs


def strict_identity_logged(dev, arch: str, what: str, quant: str | None = "int8"
                           ) -> tuple[dict, int]:
    """:func:`strict_identity` with its calls logged; returns (report, the
    int8_matmul launches it made)."""
    with CallLog() as log:
        report, graphs = strict_identity(dev, arch, quant)
    log.check(what)
    return report, (sum(c["per_call"] for c in log.calls)
                    + sum(g.replays * g.launches.get("int8_matmul", 0) for g in graphs))


def drive_serve_engine(dev, base) -> dict:
    """Chunked prefill, speculative verify and poison/resume through the int8
    engine of ``serve_dense`` (same weights, ``spec_slack`` = 4), the replayed
    ticks held bit for bit to the eager ones, and the reduced config's strict
    token identity."""
    cfg = base.cfg
    eng = engine_mod.InferenceEngine(cfg, params=base.params,
                                     sc=engine_mod.ServeConfig(**ENGINE_SC))
    vocab, per_call = cfg.vocab_size, 7 * cfg.num_layers
    rng = np.random.default_rng(40)
    report, k5_rows = {}, []
    real_k5 = quant_mod.int8_matmul

    def k5_logged(*a):
        k5_rows.append(int(a[0].shape[0]))
        return real_k5(*a)

    with CallLog() as log:
        # -- chunked prefill of a group while two slots decode --------------
        pool = eng.make_pool()
        chains = {2 + i: [eng.prefill_into_slot(pool, 2 + i, p, rid=2 + i, budget=ENGINE_BUDGET)]
                  for i, p in enumerate(rng.integers(0, vocab, n).astype(np.int32)
                                        for n in DECODING_PROMPTS)}
        group = rng.integers(0, vocab, (2, GROUP_LEN)).astype(np.int32)
        n0 = len(log.calls)
        st = eng.begin_chunked_prefill(pool, [0, 1], group, rids=[0, 1],
                                       budgets=[ENGINE_BUDGET] * 2)
        while not st.done:
            eng.chunked_prefill_step(st, CHUNK_TOKENS)
            decode_chain(eng, pool, chains, 1, "serve_engine chunked prefill")
        chunk_calls = [c for c in log.calls[n0:] if c["kind"] == "prefill_chunk"]
        first = eng.finish_chunked_prefill(pool, st)
        chains.update({j: [int(first[j])] for j in range(2)})
        decode_chain(eng, pool, chains, 2, "serve_engine after the group")
        n1 = len(log.calls)
        blocking_first = [eng.prefill_into_slot(eng.make_pool(), 0, group[j], rid=j,
                                                budget=ENGINE_BUDGET) for j in range(2)]
        block_logits = torch.cat([c["logits"] for c in log.calls[n1:]])[:, :vocab]
        chunk_logits = chunk_calls[-1]["logits"][:, :vocab]
        if len(chunk_calls) != GROUP_LEN // CHUNK_TOKENS or chunk_logits.shape != (2, vocab):
            fail(f"serve_engine: {len(chunk_calls)} chunk calls of {chunk_logits.shape}")
        report["chunked_prefill"] = {
            "group": [2, GROUP_LEN], "chunk_tokens": CHUNK_TOKENS, "chunk_calls": len(chunk_calls),
            "chunk_ms": [r6(c["ms"]) for c in chunk_calls], "first_tokens": first.tolist(),
            "first_tokens_blocking": blocking_first,
            "max_abs_logit_diff_vs_blocking": r6(float((chunk_logits - block_logits).abs().max())),
            "max_abs_logit": r6(float(block_logits.abs().max())),
            "decoding_slots_ticked_between_chunks": [2, 3]}

        # -- speculative verify, teacher-forced from the plain chain --------
        prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in SPEC_PROMPTS]
        plain = eng.make_pool()
        chain = {s: [eng.prefill_into_slot(plain, s, p, rid=s, budget=ENGINE_BUDGET)]
                 for s, p in enumerate(prompts)}
        chain_logits = []
        decode_chain(eng, plain, chain, CHAIN_TICKS, "serve_engine plain chain", chain_logits)
        vpool = eng.make_pool()
        for s, p in enumerate(prompts):
            if eng.prefill_into_slot(vpool, s, p, rid=s, budget=ENGINE_BUDGET) != chain[s][0]:
                fail("serve_engine: the same prefill gave another first token")
        quant_mod.int8_matmul = k5_logged  # the first verify tick: warm-up and capture
        try:
            report["speculative"], drafts = forced_verify(eng, vpool, chain, chain_logits,
                                                          "serve_engine")
        finally:
            quant_mod.int8_matmul = real_k5
        vgraph = eng.step_graphs(vpool)[("verify", SPEC_K)]
        if set(k5_rows) != {4 * (SPEC_K + 1)} or vgraph.launches.get("int8_matmul") != per_call:
            fail(f"serve_engine: verify graph holds {vgraph.launches} launches at rows "
                 f"{sorted(set(k5_rows))} ({per_call} at M = {4 * (SPEC_K + 1)} expected)")
        report["speculative"].update(prompts=list(SPEC_PROMPTS), int8_matmul_rows=4 * (SPEC_K + 1))

        # -- poison one slot, quarantine it, resume it ------------------------
        report["poison_resume"] = poison_resume(eng, plain, prompts, chain, "serve_engine")

        # -- the replayed ticks against the eager ones -----------------------
        dgraph = eng.step_graphs(plain)[("decode", 0)]
        report["graph_vs_eager"] = {
            "decode": graph_vs_eager(dgraph, "decode tick", tok=plain.tok,
                                     pos=plain.positions(), active=plain.decode_mask()),
            "verify": graph_vs_eager(vgraph, "verify tick", tok=vpool.tok, drafts=drafts,
                                     pos=vpool.positions(), active=vpool.decode_mask())}

        report["strict_identity"], strict_graphs = strict_identity(dev)
    log.check("serve_engine")
    graphs = [g for p in (pool, plain, vpool) for g in eng.step_graphs(p).values()]
    for g in graphs:
        if g.launches.get("int8_matmul") != per_call:
            fail(f"serve_engine: a graph holds {g.launches} launches, {per_call} int8_matmul "
                 "expected")
    replayed = sum(g.replays * g.launches.get("int8_matmul", 0) for g in graphs + strict_graphs)
    report.update(calls=len(log.calls), graphs=len(graphs) + len(strict_graphs),
                  replays=sum(g.replays for g in graphs + strict_graphs),
                  int8_matmul_per_call=per_call)
    return {"expect": {"int8_matmul": sum(c["per_call"] for c in log.calls) + replayed},
            "report": report, "engine": eng, "pools": (plain, vpool), "drafts": drafts}


def time_engine_ticks(driven) -> dict:
    """Unprofiled wall time of the replayed decode and verify ticks (the
    engine's own calls, host input and output included) and of the same
    steps run eagerly on a copy of the cache, in turns, then one of each
    under the profiler."""
    eng, (plain, vpool), drafts = driven["engine"], driven["pools"], driven["drafts"]
    dgraph = eng.step_graphs(plain)[("decode", 0)]
    vgraph = eng.step_graphs(vpool)[("verify", SPEC_K)]
    dcopy = {k: v.clone() for k, v in plain.cache.items()}
    vcopy = {k: v.clone() for k, v in vpool.cache.items()}

    def eager(g, copy, outs, **inputs):
        g.load(**inputs)
        out = g.eager(copy)
        return [out[k].cpu() for k in outs]

    ticks = {
        "decode_replayed": lambda: eng.masked_decode_step(plain),
        "decode_eager": lambda: eager(dgraph, dcopy, ("next", "finite"), tok=plain.tok,
                                      pos=plain.positions(), active=plain.decode_mask()),
        "verify_replayed": lambda: eng.masked_speculative_step(vpool, drafts),
        "verify_eager": lambda: eager(vgraph, vcopy, ("tokens", "accepted", "finite"),
                                      tok=vpool.tok, drafts=drafts, pos=vpool.positions(),
                                      active=vpool.decode_mask()),
    }
    samples = {name: [] for name in ticks}
    for fn in ticks.values():
        fn()
    for i in range(TIMED_TICKS):
        order = list(ticks.items())
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples[name].append((time.perf_counter() - t0) * 1e3)
    out = {"tick_ms_median": {k: r6(statistics.median(v)) for k, v in samples.items()},
           "tick_ms": {k: [r6(t) for t in v] for k, v in samples.items()},
           "profiled": {k: profile_call(fn) for k, fn in ticks.items()}}
    med = out["tick_ms_median"]
    out["replayed_over_eager"] = {k: r6(med[f"{k}_replayed"] / med[f"{k}_eager"])
                                  for k in ("decode", "verify")}
    # the profiler slows a replay's host path several-fold: the idle share
    # against the unprofiled median is the one a served tick sees
    out["idle_share_of_unprofiled_median"] = {
        k: r6(1.0 - out["profiled"][k]["device_busy_ms"] / med[k]) for k in ticks}
    # a replay alone, back to back, timed by CUDA events: the graph's kernels
    # and the gaps between its nodes, without the tick's host copies and reads
    dgraph.load(tok=plain.tok, pos=plain.positions(), active=plain.decode_mask())
    vgraph.load(tok=vpool.tok, drafts=drafts, pos=vpool.positions(), active=vpool.decode_mask())
    out["replay_only_ms"] = {"decode": r6(time_ms(dgraph.replay, reps=10)),
                             "verify": r6(time_ms(vgraph.replay, reps=10))}

    def synced_ms(fn, n: int = TIMED_TICKS) -> float:
        samples = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        return r6(statistics.median(samples))

    # the replayed decode tick piece by piece, each piece alone and synchronised
    out["decode_tick_split_ms"] = {
        "load_inputs": synced_ms(lambda: dgraph.load(tok=plain.tok, pos=plain.positions(),
                                                     active=plain.decode_mask())),
        "one_replay": synced_ms(dgraph.replay),
        "read_outputs": synced_ms(lambda: [dgraph.outputs[k].cpu() for k in ("next", "finite")]),
        "whole_tick": synced_ms(lambda: eng.masked_decode_step(plain))}
    return out


def _quant_leaves(tree):
    out = []
    tree_map(lambda t: out.append(t) if isinstance(t, QuantTensor) else None, tree)
    return out


def check_block_card_vs_cpu(eng, dev, stack: str = "blocks",
                            body=transformer.dense_block_prefill, layered: bool = True) -> dict:
    """Layer 0 of ``stack`` of the int8 engine (``stack`` itself where it is
    not ``layered``, as zamba2's one shared block), one full-width block
    (``body``, a prefill body returning (out, cache rows)), on the card and
    on the CPU from the same weights and a 16-token prompt: the output and
    the first cache leaf held to each other."""
    cfg = eng.cfg
    p_card = tree_map(lambda t: layer_of(t, 0), eng.params[stack]) if layered else \
        eng.params[stack]
    p_cpu = tree_map(lambda t: QuantTensor(t.q.cpu(), t.scale.cpu())
                     if isinstance(t, QuantTensor) else t.cpu(), p_card)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 16)))
    x = eng.params["embed"]["tokens"][toks.to(dev)]
    with torch.inference_mode():
        y_card, rows_card = body(p_card, x, cfg)
        y_cpu, rows_cpu = body(p_cpu, x.cpu(), cfg)
    k_card, k_cpu = rows_card[0], rows_cpu[0]  # the first cache leaf: K, c or the conv tail
    worst = {}
    for name, got, want in (("out", y_card, y_cpu), ("cache", k_card, k_cpu)):
        got, want = got.float().cpu(), want.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"block card vs cpu: non-finite {name}")
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        mean = float((got - want).abs().mean())
        if err > BLOCK_TOL * scale or mean > BLOCK_MEAN_TOL * scale:
            fail(f"block card vs cpu ({cfg.name} {body.__name__}): {name} max err {err:.3e}, "
                 f"mean {mean:.3e}, over {BLOCK_TOL} / {BLOCK_MEAN_TOL} x {scale:.3e}")
        worst[name] = {"max_abs_err": r6(err), "max_abs": r6(scale), "mean_abs_err": r6(mean)}
    return {"config": cfg.name, "block": body.__name__, "tokens": 16,
            "tolerance": f"max {BLOCK_TOL}, mean {BLOCK_MEAN_TOL} x max|cpu|", **worst}


def generate_and_slots(eng, prompts, rng, what: str, report: dict):
    """``generate`` of ``prompts`` (GEN_NEW tokens) and the slot path, into
    ``report``.  Returns (the slot pool, generate's tokens)."""
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, GEN_NEW)
    report["generate"] = {"prompts": GEN_PROMPTS, "prompt_len": GEN_LEN,
                          "new_tokens": GEN_NEW, "seconds": r6(time.perf_counter() - t0)}
    pool, slot_tokens, tick_ms, slot_finite = slot_path(eng, rng)
    if not slot_finite:
        fail(f"{what}: masked_decode_step flagged a live slot non-finite")
    report["slots"] = {"max_batch": 4, "max_len": eng.sc.max_len,
                       "prompts": [image_rows(eng) + n for n in SLOT_PROMPTS],
                       "tick_ms_median": r6(statistics.median(tick_ms[1:])),
                       "tokens": slot_tokens}
    return pool, tokens


def chunked_group(eng, rng, what: str, report: dict, chunk_tokens: int = CHUNK_TOKENS):
    """A group of 2 prompts of GROUP_LEN tokens (after the image rows)
    prefilled in chunks of ``chunk_tokens`` while slots 2 and 3 decode, then
    two ticks of all four.  Returns the pool."""
    vocab, lead = eng.cfg.vocab_size, image_rows(eng)
    cpool = eng.make_pool()
    chains = {2 + i: [eng.prefill_into_slot(cpool, 2 + i, p, rid=2 + i, budget=ENGINE_BUDGET)]
              for i, p in enumerate(rng.integers(0, vocab, lead + n).astype(np.int32)
                                    for n in DECODING_PROMPTS)}
    group = rng.integers(0, vocab, (2, lead + GROUP_LEN)).astype(np.int32)
    st = eng.begin_chunked_prefill(cpool, [0, 1], group, rids=[0, 1],
                                   budgets=[ENGINE_BUDGET] * 2)
    chunks = 0
    while not st.done:
        eng.chunked_prefill_step(st, chunk_tokens)
        chunks += 1
        decode_chain(eng, cpool, chains, 1, f"{what} chunked prefill")
    first = eng.finish_chunked_prefill(cpool, st)
    chains.update({j: [int(first[j])] for j in range(2)})
    decode_chain(eng, cpool, chains, 2, f"{what} after the group")
    report["chunked_prefill"] = {"group": list(group.shape), "chunk_tokens": chunk_tokens,
                                 "chunk_calls": chunks, "first_tokens": first.tolist()}
    return cpool


def verify_steps(eng, rng, what: str, report: dict):
    """The plain chain of SPEC_PROMPTS (after the image rows; CHAIN_TICKS
    decode ticks) and, from the same prefills, the teacher-forced verify
    ticks (:func:`forced_verify`).  Returns (plain pool, verify pool,
    prompts, chain, the last drafts)."""
    vocab, lead = eng.cfg.vocab_size, image_rows(eng)
    prompts = [rng.integers(0, vocab, lead + n).astype(np.int32) for n in SPEC_PROMPTS]
    plain = eng.make_pool()
    chain = {s: [eng.prefill_into_slot(plain, s, p, rid=s, budget=ENGINE_BUDGET)]
             for s, p in enumerate(prompts)}
    chain_logits = []
    decode_chain(eng, plain, chain, CHAIN_TICKS, f"{what} plain chain", chain_logits)
    vpool = eng.make_pool()
    for s, p in enumerate(prompts):
        if eng.prefill_into_slot(vpool, s, p, rid=s, budget=ENGINE_BUDGET) != chain[s][0]:
            fail(f"{what}: the same prefill gave another first token")
    report["speculative"], drafts = forced_verify(eng, vpool, chain, chain_logits, what)
    return plain, vpool, prompts, chain, drafts


def poison_resume(eng, plain, prompts, chain, what: str) -> dict:
    """Poison slot 1 of ``plain`` (decoding ``chain``), see it alone flagged,
    quarantine it, resume it from its committed context, two more ticks."""
    eng.poison_slot(plain, 1)
    nxt, fin = eng.masked_decode_step(plain)
    if fin[1] or not fin[[0, 2, 3]].all():
        fail(f"{what}: after poisoning slot 1, finite {fin}")
    for s in (0, 2, 3):
        plain.advance(s, 1, int(nxt[s]))
        chain[s].append(int(nxt[s]))
    plain.retire(1)
    context = np.concatenate([prompts[1], np.asarray(chain[1][:-1], np.int32)])
    eng.resume_into_slot(plain, 1, context, rid=1, budget=ENGINE_BUDGET,
                         emitted=len(chain[1]), next_tok=chain[1][-1])
    resumed = {s: [] for s in range(4)}
    decode_chain(eng, plain, resumed, 2, f"{what} after resume")
    return {"finite_after_poison": fin.tolist(), "resumed_tokens": resumed[1]}


def ticks_vs_eager(eng, plain, vpool, drafts, what: str) -> dict:
    """:func:`graph_vs_eager` for the decode tick of ``plain`` and the verify
    tick of ``vpool``."""
    dgraph = eng.step_graphs(plain)[("decode", 0)]
    vgraph = eng.step_graphs(vpool)[("verify", SPEC_K)]
    return {"decode": graph_vs_eager(dgraph, f"{what} decode tick", tok=plain.tok,
                                     pos=plain.positions(), active=plain.decode_mask()),
            "verify": graph_vs_eager(vgraph, f"{what} verify tick", tok=vpool.tok,
                                     drafts=drafts, pos=vpool.positions(),
                                     active=vpool.decode_mask())}


def graph_launches(graphs, cfg, what: str) -> int:
    """Every graph holds ``k5_per_call`` int8_matmul launches of its kind;
    returns the launches their replays ran."""
    for g in graphs:
        kind = "decode_verify" if "drafts" in g.inputs else "decode_step"
        if g.launches.get("int8_matmul") != k5_per_call(cfg, kind):
            fail(f"{what}: a {kind} graph holds {g.launches} launches, "
                 f"{k5_per_call(cfg, kind)} int8_matmul expected")
    return sum(g.replays * g.launches.get("int8_matmul", 0) for g in graphs)


def twin_agreement(full, prompts, tokens, what: str) -> float:
    """Greedy-chain agreement of ``tokens`` with the bf16 twin's ``generate``
    of the same prompts, held to AGREEMENT_FLOOR."""
    agreement = float((tokens == full.generate(prompts, GEN_NEW)).mean())
    if agreement < AGREEMENT_FLOOR:
        fail(f"{what}: greedy-chain agreement {agreement:.3f} with the bf16 engine, "
             f"under the floor {AGREEMENT_FLOOR}")
    return agreement


# ---------------------------------------------------------------------------
# serve_moe: the moe family at full width, the expert einsums one K5 launch
# over the expert axis
# ---------------------------------------------------------------------------
MOE = "granite-moe-3b-a800m"        # full width, full depth (32 layers)
DEEPSEEK = "deepseek-v3-671b"
DEEPSEEK_LAYERS = 2                 # the only cut: 61 → 2 layers, one MLA-dense, one MLA-MoE
# Verify's agreement with plain decode on the moe family, below the dense
# engine's 0.95: both configs read 0.9375-0.953 over 64 positions (H100
# 80GB HBM3, 700 W), every flip at a near tie (VERIFY_TIE): bf16 rounding
# that differs between the window and single steps moves a router near its
# top-k edge (gaps of 1e-5 to 3e-3 in probability) or a logit near a tie.
# 0.85 leaves room for that rate's spread (~3.5 flips of 64) and fails a
# verify wrong at one position in six.  internvl2-76b (8 layers at full
# width, vocab 128256) reads the same: 0.922-1.0 over seven prompt draws,
# mean 0.973, every flip at a chain margin of 0-2.1% (1-3 bf16 ulps of its
# logits; ``agreement_check.py``'s six draws and this script's own, same
# card), so the vlm takes this floor.
MOE_VERIFY_FLOOR = 0.85


def twin_engines(dev, cfg_f, sc: dict = ENGINE_SC):
    """The int8 engine and its bf16 twin over the same random weights (seed
    0, attention at the standard fan-in), with ``spec_slack`` for verify."""
    params = init_model(cfg_f, torch.Generator(device=dev).manual_seed(0), dev)
    standard_fan_in(params, cfg_f)
    sc = engine_mod.ServeConfig(**sc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = engine_mod.InferenceEngine(dataclasses.replace(cfg_f, quant="int8"), params=params,
                                     sc=sc)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    return eng, engine_mod.InferenceEngine(cfg_f, params=params, sc=sc), init_s


def serve_moe_config(dev, arch: str, layers: int | None) -> dict:
    """One config of the moe family through the int8 engine: ``generate``,
    the slot path (replayed ticks), a chunked prefill while two slots
    decode, verify ticks teacher-forced from the plain chain (as
    ``serve_engine``'s); the replayed ticks against the eager ones; greedy agreement
    with the bf16 engine on the same weights; one block on the card against
    the CPU (its launches recorded apart, not counted)."""
    t_start = time.perf_counter()
    cfg_f = get_config(arch)
    if layers is not None:
        cfg_f = dataclasses.replace(cfg_f, num_layers=layers, first_k_dense=min(
            cfg_f.first_k_dense, layers - 1))
    torch.cuda.reset_peak_memory_stats()
    eng, full, init_s = twin_engines(dev, cfg_f)
    cfg, vocab = eng.cfg, cfg_f.vocab_size
    rng = np.random.default_rng(60)
    prompts = rng.integers(0, vocab, (GEN_PROMPTS, GEN_LEN)).astype(np.int32)
    report = {"arch": arch, "layers": cfg.num_layers, "of_layers": get_config(arch).num_layers,
              "first_k_dense": cfg.first_k_dense, "dtype": "bfloat16", "quant": "int8",
              "int8_weight_bytes": sum(t.q.numel() for t in _quant_leaves(eng.params)),
              "quantize_at_init_s": r6(init_s)}
    what = f"serve_moe {arch}"
    with CallLog() as log:
        pool, tokens_q = generate_and_slots(eng, prompts, rng, what, report)
        # where a replayed tick's time goes: K5 against the bytes it must read
        tick = profile_call(lambda: eng.masked_decode_step(pool))
        k5_bytes = sum(t.q.numel() + 4 * t.scale.numel()
                       for stack in ("dense_blocks", "blocks") if stack in eng.params
                       for t in _quant_leaves(eng.params[stack]))
        report["decode_tick_profile"] = {
            **tick, "int8_weight_bytes_a_tick": k5_bytes,
            "int8_matmul_bound_ms": r6(k5_bytes / PEAK_BYTES_PER_S * 1e3),
            "int8_matmul_share_of_busy": r6(tick["int8_matmul_device_ms"]
                                            / tick["device_busy_ms"])}
        cpool = chunked_group(eng, rng, what, report)
        plain, vpool, _, _, drafts = verify_steps(eng, rng, what, report)
        report["graph_vs_eager"] = ticks_vs_eager(eng, plain, vpool, drafts, what)
        graphs = [g for p in (pool, cpool, plain, vpool) for g in eng.step_graphs(p).values()]
    log.check(what)
    replayed = graph_launches(graphs, cfg, what)
    agreement = twin_agreement(full, prompts, tokens_q, what)
    stack, body = (("blocks", transformer.dense_block_prefill) if cfg.mla is None
                   else ("dense_blocks", transformer.mla_block_prefill))
    with runtime.launches_recorded() as block_launches:  # a module check, not the path
        report["block_card_vs_cpu"] = check_block_card_vs_cpu(eng, dev, stack, body)
    want = k5_per_call(dataclasses.replace(cfg, num_layers=1, first_k_dense=cfg.first_k_dense
                                           and 1), "prefill")
    if block_launches.get("int8_matmul") != want:
        fail(f"serve_moe {arch}: the block on the card launched {block_launches}, "
             f"{want} int8_matmul expected")
    report["block_card_vs_cpu"]["int8_matmul_launches"] = want
    decode_ms = [c["ms"] for c in log.calls if c["kind"] == "decode_step"]
    report.update({
        "int8_matmul_per_call": {k: k5_per_call(cfg, k) for k in
                                 ("prefill", "decode_step", "prefill_chunk", "decode_verify")},
        "calls": len(log.calls), "graphs": len(graphs),
        "replays": sum(g.replays for g in graphs),
        "eager_decode_ms_median": r6(statistics.median(decode_ms)),
        "greedy_agreement_vs_bf16": r6(agreement), "agreement_floor": AGREEMENT_FLOOR,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "seconds": r6(time.perf_counter() - t_start)})
    return {"int8_matmul": sum(c["per_call"] for c in log.calls) + replayed, "report": report}


def drive_serve_moe(dev) -> dict:
    """granite-moe-3b-a800m at full width and depth, then (its engines
    freed) deepseek-v3-671b at full width and 2 layers, then the reduced
    configs of both in f32, token for token: granite-moe with int8 weights
    chunked == blocking and speculative == plain; deepseek both with
    full-precision weights, and speculative == plain with int8 weights."""
    moe = serve_moe_config(dev, MOE, None)
    torch.cuda.empty_cache()
    deepseek = serve_moe_config(dev, DEEPSEEK, DEEPSEEK_LAYERS)
    torch.cuda.empty_cache()
    report = {"granite_moe": moe["report"], "deepseek": deepseek["report"], "strict_identity": {}}
    expect = moe["int8_matmul"] + deepseek["int8_matmul"]
    for arch, quant in ((MOE, "int8"), (DEEPSEEK, None), (DEEPSEEK, "int8")):
        report["strict_identity"][f"{arch} {quant or 'f32'}"], launched = strict_identity_logged(
            dev, arch, f"serve_moe strict identity {arch} {quant}", quant)
        expect += launched
    return {"expect": {"int8_matmul": expect}, "report": report}


# ---------------------------------------------------------------------------
# serve_ssm: the ssm and hybrid families at full width and full depth
# ---------------------------------------------------------------------------
SSM_ARCHS = ("mamba2-780m", "zamba2-7b")  # full width, full depth: 48 and 81 Mamba2 layers
LONG_PROMPT, LONG_CHUNK = 512, 64       # two of the 256-token SSD chunks; its composition in 64s
# The long prompt's blocking prefill against its chunked composition, bf16
# with int8 weights, per leaf: the two sum the same recurrence in other
# orders and round to bf16 after every layer, and a last-bit difference can
# move an activation across an int8 rounding edge; over 48-81 layers that
# drift is the noise (the reduced zamba2 in bf16 on the CPU: logits max 7.5%,
# mean 1.7% of the largest; shared K/V max 14%, mean 0.8%).  A wrong carry of
# the state or the conv tail moves them by their own size.  Max within
# VERIFY_LOGIT_DIFF, mean within 0.02 (the int8 mean rule of the CPU tests)
# of the largest magnitude.
LONG_TOL, LONG_MEAN_TOL = VERIFY_LOGIT_DIFF, 0.02


def shared_block_prefill(p, x, cfg):
    """zamba2's shared attention block over a prompt, ``x`` also its x0 (the
    first application, where the block's input is the embedding)."""
    return transformer.shared_attn_prefill(p, x, x, cfg)


def held(got: torch.Tensor, want: torch.Tensor, what: str, tol: float, mean_tol: float) -> dict:
    """Max and mean |got - want| against ``tol`` / ``mean_tol`` times the
    largest |want|; fails past either."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite values")
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    mean = float((got - want).abs().mean())
    if err > tol * scale or mean > mean_tol * scale:
        fail(f"{what}: max err {err:.3e}, mean {mean:.3e}, over {tol} / {mean_tol} x {scale:.3e}")
    return {"max_abs_err": r6(err), "mean_abs_err": r6(mean), "max_abs": r6(scale)}


def tree_tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of tensors and ``QuantTensor`` leaves (a
    ``QuantTensor`` gives its payload and its scales)."""
    return [x for leaf in tree_leaves(tree)
            for x in (leaf if isinstance(leaf, QuantTensor) else (leaf,))]


def tree_bytes(tree) -> int:
    """Device bytes of a tree of tensors and ``QuantTensor`` leaves."""
    return sum(x.numel() * x.element_size() for x in tree_tensors(tree))


def ssm_tick_bytes(eng, pool) -> dict:
    """Bytes one decode tick of the pool must move: every weight once (the
    shared block once per application, the unembedding: the tied table for
    mamba2), the (conv, state) of every layer read and written, and the
    shared K/V read over the pool's capacity."""
    cfg, p = eng.cfg, eng.params
    apps = math.ceil(cfg.num_layers / cfg.attn_every) if "shared" in p else 0
    unembed = p["embed"].get("unembed", p["embed"]["tokens"])
    weights = {"mamba_layers": tree_bytes(p["blocks"]),
               "shared_block_x_applications": apps * tree_bytes(p.get("shared", {})),
               "unembedding": tree_bytes(unembed)}
    state = {"conv_and_state_read_and_written": 2 * tree_bytes(
        [pool.cache["conv"], pool.cache["state"]]),
        "shared_kv_read": tree_bytes([pool.cache[k] for k in pool.cache
                                      if k.startswith("shared")])}
    total = sum(weights.values()) + sum(state.values())
    return {"weights": weights, "state": state, "total": total,
            "bound_ms": r6(total / PEAK_BYTES_PER_S * 1e3), "bound_by": "bytes"}


def snapshot_bytes(cfg, batch: int, window: int) -> dict:
    """What a verify window of ``window`` tokens keeps for the rollback, at
    ``batch`` slots: the reference's per-position snapshots of every layer
    (state f32, conv tail in the cache's type), and the port's
    ``ssm.VerifyCarry`` (the raw window in the cache's type; cum, dt·x and B
    in f32)."""
    s, layers = cfg.ssm, cfg.num_layers
    h, p, n, w = s.num_heads(cfg.d_model), s.head_dim, s.state_size, s.conv_width
    c, item = s.d_inner(cfg.d_model) + 2 * n, cfg.dtype.itemsize
    carry = batch * ((w - 1 + window) * c * item + window * (h + h * p + n) * 4)
    return {"batch": batch, "window": window,
            "reference_state_snapshots": layers * batch * window * h * p * n * 4,
            "reference_conv_snapshots": layers * batch * window * (w - 1) * c * item,
            "verify_carry": layers * carry}


def long_prompt(eng, dev) -> dict:
    """One prompt of ``LONG_PROMPT`` tokens through ``prefill`` (two SSD
    chunks of 256: the inter-chunk scan at full width) and the same prompt
    as chunked prefill in chunks of ``LONG_CHUNK``, both through the
    engine's model calls (logged and counted): the last logits and every
    cache leaf held to each other (``LONG_TOL``)."""
    cfg = eng.cfg
    toks = torch.as_tensor(np.random.default_rng(71).integers(0, cfg.vocab_size, (
        1, LONG_PROMPT)), device=dev)
    with torch.inference_mode():
        logits, cache = engine_mod.prefill(eng.params, toks, cfg)
        chunked = init_params(cache_defs(cfg, batch=1, max_len=LONG_PROMPT), torch.Generator(),
                              dev)
        for pos in range(0, LONG_PROMPT, LONG_CHUNK):
            clog, chunked = engine_mod.prefill_chunk(eng.params, chunked,
                                                     toks[:, pos:pos + LONG_CHUNK], pos, cfg)
    vocab = cfg.vocab_size
    out = {"tokens": LONG_PROMPT, "ssd_chunk": cfg.ssm.chunk_size, "chunk_tokens": LONG_CHUNK,
           "tolerance": f"max {LONG_TOL}, mean {LONG_MEAN_TOL} x max|blocking|",
           "last_logits": held(clog[:, :vocab], logits[:, :vocab], f"serve_ssm {cfg.name} long "
                               "prompt logits", LONG_TOL, LONG_MEAN_TOL),
           "argmax_blocking": int(logits[0, :vocab].argmax()),
           "argmax_chunked": int(clog[0, :vocab].argmax())}
    for key, t in cache.items():
        out[key] = held(chunked[key], t, f"serve_ssm {cfg.name} long prompt cache {key!r}",
                        LONG_TOL, LONG_MEAN_TOL)
    return out


def serve_ssm_config(dev, arch: str) -> dict:
    """One config of the ssm or hybrid family at full width and depth through
    the int8 engine: ``generate``, the slot path (replayed ticks, timed and
    profiled beside the bytes a tick must move), a chunked prefill while two
    slots decode, verify ticks teacher-forced from the plain chain (each row
    rolled back to its own accepted count), poison → quarantine → resume, the
    replayed ticks against the eager ones, the long prompt's two-chunk scan
    against its chunked composition; greedy agreement with the bf16 engine
    on the same weights; one Mamba2 block (and zamba2's shared block) on the
    card against the CPU."""
    t_start = time.perf_counter()
    cfg_f = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    eng, full, init_s = twin_engines(dev, cfg_f)
    cfg, vocab = eng.cfg, cfg_f.vocab_size
    rng = np.random.default_rng(70)
    prompts = rng.integers(0, vocab, (GEN_PROMPTS, GEN_LEN)).astype(np.int32)
    report = {"arch": arch, "family": cfg.family, "layers": cfg.num_layers,
              "of_layers": get_config(arch).num_layers,
              "shared_applications": math.ceil(cfg.num_layers / cfg.attn_every)
              if cfg.family == "hybrid" else 0,
              "dtype": "bfloat16", "quant": "int8",
              "int8_weight_bytes": sum(t.q.numel() for t in _quant_leaves(eng.params)),
              "quantize_at_init_s": r6(init_s)}
    what = f"serve_ssm {arch}"
    with CallLog() as log:
        pool, tokens_q = generate_and_slots(eng, prompts, rng, what, report)
        # the replayed decode tick: unprofiled, profiled, and what it must move
        replayed = []
        for _ in range(TIMED_TICKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.masked_decode_step(pool)
            replayed.append((time.perf_counter() - t0) * 1e3)
        tick = profile_call(lambda: eng.masked_decode_step(pool))
        moved = ssm_tick_bytes(eng, pool)
        report["decode_tick"] = {
            "unprofiled_ms_median": r6(statistics.median(replayed)),
            "unprofiled_ms": [r6(t) for t in replayed], "profile": tick, "bytes": moved,
            "busy_over_bound": r6(tick["device_busy_ms"] / moved["bound_ms"]),
            "int8_matmul_share_of_busy": r6(tick["int8_matmul_device_ms"]
                                            / tick["device_busy_ms"])}
        cpool = chunked_group(eng, rng, what, report)
        plain, vpool, sprompts, chain, drafts = verify_steps(eng, rng, what, report)
        report["poison_resume"] = poison_resume(eng, plain, sprompts, chain, what)
        report["graph_vs_eager"] = ticks_vs_eager(eng, plain, vpool, drafts, what)
        report["long_prompt"] = long_prompt(eng, dev)
        report["verify_snapshot_bytes"] = snapshot_bytes(cfg, vpool.max_batch, SPEC_K + 1)
        graphs = [g for p in (pool, cpool, plain, vpool) for g in eng.step_graphs(p).values()]
    log.check(what)
    replays = graph_launches(graphs, cfg, what)
    agreement = twin_agreement(full, prompts, tokens_q, what)
    del full
    blocks = [("mamba", "blocks", transformer.ssm_block_prefill, True, 3)]
    if "shared" in eng.params:
        blocks.append(("shared", "shared", shared_block_prefill, False, 9))
    report["block_card_vs_cpu"] = {}
    for name, stack, body, layered, want in blocks:
        with runtime.launches_recorded() as block_launches:  # a module check, not the path
            r = check_block_card_vs_cpu(eng, dev, stack, body, layered)
        if block_launches.get("int8_matmul") != want:
            fail(f"serve_ssm {arch}: the {name} block on the card launched {block_launches}, "
                 f"{want} int8_matmul expected")
        report["block_card_vs_cpu"][name] = dict(r, int8_matmul_launches=want)
    decode_ms = [c["ms"] for c in log.calls if c["kind"] == "decode_step"]
    report.update({
        "int8_matmul_per_call": k5_per_call(cfg, "decode_step"),
        "calls": len(log.calls), "graphs": len(graphs),
        "replays": sum(g.replays for g in graphs),
        "eager_decode_ms_median": r6(statistics.median(decode_ms)),
        "greedy_agreement_vs_bf16": r6(agreement), "agreement_floor": AGREEMENT_FLOOR,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "seconds": r6(time.perf_counter() - t_start)})
    return {"int8_matmul": sum(c["per_call"] for c in log.calls) + replays, "report": report}


def drive_serve_ssm(dev) -> dict:
    """mamba2-780m, then (its engines freed) zamba2-7b, each at full width and
    full depth, then the reduced configs of both in f32 with int8 weights,
    token for token: chunked == blocking and speculative == plain."""
    report, expect = {"strict_identity": {}}, 0
    for arch in SSM_ARCHS:
        out = serve_ssm_config(dev, arch)
        report[arch] = out["report"]
        expect += out["int8_matmul"]
        torch.cuda.empty_cache()
    for arch in SSM_ARCHS:
        report["strict_identity"][arch], launched = strict_identity_logged(
            dev, arch, f"serve_ssm strict identity {arch}")
        expect += launched
    return {"expect": {"int8_matmul": expect}, "report": report}


# ---------------------------------------------------------------------------
# serve_audio and serve_vlm: the enc-dec audio family (whisper-tiny) and the
# vision-language model (internvl2-76b) through the same engine
# ---------------------------------------------------------------------------
WHISPER = "whisper-tiny"            # full width, full depth: 4 encoder + 4 decoder layers
WHISPER_K5_M, WHISPER_K5_KN = (4, 1500, 6000), [(384, 384), (384, 1536), (1536, 384)]
VLM_K5_M = (4, 20, 96, 320, 1280)
VLM_K5_KN = [(8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192)]
VLM = "internvl2-76b"
VLM_LAYERS = 8                      # the only cut: 80 → 8 layers (int8 + the bf16 twin fit)
VLM_SC = {"max_batch": 4, "max_len": 384, "spec_slack": 4}  # 256 image rows + text + budget
VLM_CHUNK = 48                      # chunks 240-288 of a 320-position prompt straddle 256
FRONTEND_PROMPT = 64                # the text tokens of the random-input prefill


def encoder_block(p, x, cfg):
    """whisper's encoder block over ``x``, with its attention's (k, v), for
    :func:`check_block_card_vs_cpu` (``transformer.enc_block_apply``, the
    attention's rows kept)."""
    a, kv = transformer.gqa_full(p["attn"], transformer.apply_norm(cfg, p["ln1"], x), cfg,
                                 causal=False, rope=False)
    return transformer._ffn(p, x + a, cfg)[0], kv


def decoder_block():
    """whisper's decoder prefill body over seeded random frames (numpy, std
    1, 1500 x 384) as the encoder output, on whichever device its input
    lies: its cache rows are (k, v, cross_k, cross_v)."""
    cfg = get_config(WHISPER)
    enc = np.random.default_rng(81).standard_normal((1, cfg.encoder_seq, cfg.d_model))

    def decoder_block(p, x, cfg):
        e = torch.as_tensor(enc, dtype=x.dtype, device=x.device)
        return transformer.dec_block_prefill(p, x, e, cfg)

    return decoder_block


def attention_tick_bytes(eng, pool) -> dict:
    """Bytes one decode tick of the pool must move: the decoder's weights
    once (the stack, the final norm, the unembedding: whisper's tied table,
    internvl2's own), the self-attention K/V read over the pool's capacity,
    and whisper's cross K/V read over its frames."""
    p = eng.params
    unembed = p["embed"].get("unembed", p["embed"]["tokens"])
    weights = {"decoder_layers": tree_bytes(p["blocks"]),
               "final_norm": tree_bytes(p["final_norm"]), "unembedding": tree_bytes(unembed)}
    cache = {"kv_read": tree_bytes([pool.cache["k"], pool.cache["v"]]),
             "cross_kv_read": tree_bytes([pool.cache[k] for k in ("cross_k", "cross_v")
                                          if k in pool.cache])}
    total = sum(weights.values()) + sum(cache.values())
    return {"weights": weights, "cache": cache, "total": total,
            "cross_kv_a_slot": cache["cross_kv_read"] // pool.max_batch,
            "bound_ms": r6(total / PEAK_BYTES_PER_S * 1e3), "bound_by": "bytes"}


def frontend_prefill(eng, dev) -> dict:
    """One prompt through ``prefill`` with seeded random front-end inputs
    (numpy): whisper's 1500 frames at std 1, internvl2's 256 patch
    embeddings at the token embedding's scale (0.02) ahead of
    ``FRONTEND_PROMPT`` text tokens; and the same prompt as its chunked
    composition: whisper's cross K/V from ``encoder_cross_cache``, then
    chunks of ``CHUNK_TOKENS``; internvl2's patches padded to the prompt's
    length, chunks of ``VLM_CHUNK``.  All through the engine's model calls
    (logged and counted).  The last logits and every layer's K/V held to
    each other (``LONG_TOL``), whisper's cross K/V the same bits."""
    cfg = eng.cfg
    rng = np.random.default_rng(82)
    lead = image_rows(eng)
    n = lead + FRONTEND_PROMPT
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)), device=dev)
    if cfg.family == "audio":
        fe = rng.standard_normal((1, cfg.encoder_seq, cfg.d_model))
        chunk = CHUNK_TOKENS
    else:
        fe = rng.standard_normal((1, cfg.frontend_seq, cfg.d_model)) * 0.02
        chunk = VLM_CHUNK
    fe = torch.as_tensor(fe, dtype=cfg.dtype, device=dev)
    with torch.inference_mode():
        logits, cache = engine_mod.prefill(eng.params, toks, cfg, frontend_embeds=fe)
        chunked = init_params(cache_defs(cfg, batch=1, max_len=n), torch.Generator(), dev)
        padded = None
        if cfg.family == "audio":
            ck, cv = engine_mod.encoder_cross_cache(eng.params, cfg, fe)
            chunked["cross_k"].copy_(ck)
            chunked["cross_v"].copy_(cv)
        else:
            padded = torch.zeros((1, n, cfg.d_model), dtype=cfg.dtype, device=dev)
            padded[:, :lead] = fe
        for pos in range(0, n, chunk):
            clog, chunked = engine_mod.prefill_chunk(eng.params, chunked, toks[:, pos:pos + chunk],
                                                     pos, cfg, frontend_embeds=padded)
    vocab, what = cfg.vocab_size, f"{cfg.name} random-input prefill"
    out = {"tokens": n, "front_end": list(fe.shape), "chunk_tokens": chunk,
           "tolerance": f"max {LONG_TOL}, mean {LONG_MEAN_TOL} x max|blocking|",
           "last_logits": held(clog[:, :vocab], logits[:, :vocab], f"{what} logits", LONG_TOL,
                               LONG_MEAN_TOL),
           "argmax_blocking": int(logits[0, :vocab].argmax()),
           "argmax_chunked": int(clog[0, :vocab].argmax())}
    for key in ("k", "v"):
        out[key] = held(chunked[key], cache[key], f"{what} cache {key!r}", LONG_TOL,
                        LONG_MEAN_TOL)
    for key in ("cross_k", "cross_v"):
        if key in cache:
            if not same_bits(chunked[key], cache[key]):
                fail(f"{what}: encoder_cross_cache's {key} is not prefill's, bit for bit")
            out[key] = "bitwise equal"
    return out


def serve_frontend_config(dev, arch: str, layers: int | None, sc: dict, chunk_tokens: int,
                          blocks) -> dict:
    """One config with a front-end through the int8 engine, as
    :func:`serve_ssm_config`: ``generate``, the slot path (the replayed
    decode tick timed, profiled and set beside :func:`attention_tick_bytes`),
    a chunked prefill while two slots decode (in chunks of
    ``chunk_tokens``), verify ticks teacher-forced from the plain chain,
    poison → quarantine → resume (whisper: the resumed slot's cross K/V
    those of a fresh prefill of its context, bit for bit), the replayed
    ticks against the eager ones, :func:`frontend_prefill`; greedy
    agreement with the bf16 twin; ``blocks`` (name, stack, prefill body,
    int8_matmul launches) on the card against the CPU."""
    t_start = time.perf_counter()
    cfg_f = get_config(arch)
    if layers is not None:
        cfg_f = dataclasses.replace(cfg_f, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    eng, full, init_s = twin_engines(dev, cfg_f, sc)
    cfg, vocab = eng.cfg, cfg_f.vocab_size
    rng = np.random.default_rng(80)
    prompts = rng.integers(0, vocab, (GEN_PROMPTS, image_rows(eng) + GEN_LEN)).astype(np.int32)
    report = {"arch": arch, "family": cfg.family, "layers": cfg.num_layers,
              "of_layers": get_config(arch).num_layers, "encoder_layers": cfg.encoder_layers,
              "image_rows": image_rows(eng), "dtype": "bfloat16", "quant": "int8",
              "serve_config": sc,
              "int8_weight_bytes": sum(t.q.numel() for t in _quant_leaves(eng.params)),
              "quantize_at_init_s": r6(init_s)}
    what = f"serve {arch}"
    with CallLog() as log:
        pool, tokens_q = generate_and_slots(eng, prompts, rng, what, report)
        replayed = []
        for _ in range(TIMED_TICKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.masked_decode_step(pool)
            replayed.append((time.perf_counter() - t0) * 1e3)
        tick = profile_call(lambda: eng.masked_decode_step(pool))
        moved = attention_tick_bytes(eng, pool)
        report["decode_tick"] = {
            "unprofiled_ms_median": r6(statistics.median(replayed)),
            "unprofiled_ms": [r6(t) for t in replayed], "profile": tick, "bytes": moved,
            "busy_over_bound": r6(tick["device_busy_ms"] / moved["bound_ms"]),
            "int8_matmul_share_of_busy": r6(tick["int8_matmul_device_ms"]
                                            / tick["device_busy_ms"])}
        cpool = chunked_group(eng, rng, what, report, chunk_tokens)
        plain, vpool, sprompts, chain, drafts = verify_steps(eng, rng, what, report)
        report["poison_resume"] = poison_resume(eng, plain, sprompts, chain, what)
        if cfg.family == "audio":
            context = np.concatenate([sprompts[1], np.asarray(chain[1][:-1], np.int32)])
            with torch.inference_mode():  # a fresh prefill of the context, outside the count
                with runtime.launches_recorded():
                    _, fresh = model_mod.prefill(
                        eng.params, torch.as_tensor(context[None].astype(np.int64), device=dev),
                        cfg, frontend_embeds=eng._frontend_stub(1))
            for key in ("cross_k", "cross_v"):
                if not same_bits(plain.cache[key][:, 1], fresh[key][:, 0]):
                    fail(f"{what}: the resumed slot's {key} is not a fresh prefill's")
            report["poison_resume"]["resumed_cross_kv"] = "bitwise equal to a fresh prefill's"
        report["graph_vs_eager"] = ticks_vs_eager(eng, plain, vpool, drafts, what)
        report["frontend_prefill"] = frontend_prefill(eng, dev)
        graphs = [g for p in (pool, cpool, plain, vpool) for g in eng.step_graphs(p).values()]
    log.check(what)
    replays = graph_launches(graphs, cfg, what)
    tokens_f = full.generate(prompts, GEN_NEW)
    agreement = float((tokens_q == tokens_f).mean())
    per_step = step_agreement(eng, full, prompts, tokens_f, dev)
    # the vision-language model's chains part at near ties within a few
    # tokens (0.03-0.31 over six prompt draws, ``agreement_check.py``) while its
    # per-step agreement reads 0.59-0.75: there the floor holds the per-step
    # agreement, which the chain agreement lower-bounds; whisper the chain's
    gated = per_step["agreement"] if cfg.family == "vlm" else agreement
    if gated < AGREEMENT_FLOOR:
        fail(f"{what}: agreement {gated:.3f} with the bf16 engine (chain {agreement:.3f}, "
             f"per step {per_step['agreement']}), under the floor {AGREEMENT_FLOOR}")
    del full
    report["block_card_vs_cpu"] = {}
    for name, stack, body, want in blocks:
        with runtime.launches_recorded() as block_launches:  # a module check, not the path
            r = check_block_card_vs_cpu(eng, dev, stack, body)
        if block_launches.get("int8_matmul") != want:
            fail(f"{what}: the {name} block on the card launched {block_launches}, "
                 f"{want} int8_matmul expected")
        report["block_card_vs_cpu"][name] = dict(r, int8_matmul_launches=want)
    decode_ms = [c["ms"] for c in log.calls if c["kind"] == "decode_step"]
    report.update({
        "int8_matmul_per_call": {k: k5_per_call(cfg, k) for k in (
            "prefill", "decode_step", "prefill_chunk", "decode_verify",
            *(("encoder_cross_cache",) if cfg.family == "audio" else ()))},
        "calls": len(log.calls), "graphs": len(graphs),
        "replays": sum(g.replays for g in graphs),
        "eager_decode_ms_median": r6(statistics.median(decode_ms)),
        "greedy_agreement_vs_bf16": r6(agreement), "step_agreement_vs_bf16": per_step,
        "agreement_floor": AGREEMENT_FLOOR,
        "floor_holds": "per-step agreement" if cfg.family == "vlm" else "chain agreement",
        "distinct_tokens": {"generate": len(set(tokens_q.ravel().tolist())),
                            "of": int(tokens_q.size)},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "seconds": r6(time.perf_counter() - t_start)})
    return {"int8_matmul": sum(c["per_call"] for c in log.calls) + replays, "report": report}


def step_agreement(eng, full, prompts, chain_f, dev) -> dict:
    """Per-step agreement with the bf16 twin: the int8 model's argmax at each
    of the twin's greedy positions, given the twin's own chain as context
    (teacher-forced, one forward pass of each; launches recorded apart), and
    the largest |int8 - bf16| of those logits over the largest |logit|.
    The greedy-chain agreement is a lower bound of it (``docs/kernels.md``):
    two chains part for good at their first flip."""
    b, n = chain_f.shape
    ctx = np.concatenate([prompts, chain_f[:, :-1]], axis=1).astype(np.int64)
    toks = torch.as_tensor(ctx, device=dev)
    vocab, last = eng.cfg.vocab_size, prompts.shape[1] - 1
    logits = []
    with torch.inference_mode(), runtime.launches_recorded():
        for e in (eng, full):
            hidden, _ = model_mod.forward(e.params, toks, e.cfg, e._frontend_stub(b))
            logits.append(unembed_apply(e.params["embed"], hidden[:, last:], e.cfg)[
                ..., :vocab].float())
    lq, lf = logits
    scale = lf.abs().amax(dim=-1)
    return {"positions": b * n,
            "agreement": r6(float((lq.argmax(-1).cpu().numpy() == chain_f).mean())),
            "logits_max_abs_diff_rel": r6(float(((lq - lf).abs().amax(-1) / scale).max()))}


def drive_serve_audio(dev) -> dict:
    """whisper-tiny at full width and full depth (4 + 4 layers, no cut),
    then its reduced config in f32 with int8 weights, token for token:
    chunked == blocking and speculative == plain."""
    blocks = [("encoder", "enc_blocks", encoder_block, 6),
              ("decoder", "blocks", decoder_block(), 10)]
    out = serve_frontend_config(dev, WHISPER, None, ENGINE_SC, CHUNK_TOKENS, blocks)
    torch.cuda.empty_cache()
    identity, launched = strict_identity_logged(dev, WHISPER, "serve_audio strict identity")
    return {"expect": {"int8_matmul": out["int8_matmul"] + launched},
            "report": {WHISPER: out["report"], "strict_identity": identity}}


def drive_serve_vlm(dev) -> dict:
    """internvl2-76b at full width, cut to ``VLM_LAYERS`` layers, its prompts
    256 image positions (the engine's stub) and then text; then its reduced
    config in f32 with int8 weights, token for token."""
    blocks = [("decoder", "blocks", transformer.dense_block_prefill, 7)]
    out = serve_frontend_config(dev, VLM, VLM_LAYERS, VLM_SC, VLM_CHUNK, blocks)
    torch.cuda.empty_cache()
    identity, launched = strict_identity_logged(dev, VLM, "serve_vlm strict identity")
    return {"expect": {"int8_matmul": out["int8_matmul"] + launched},
            "report": {VLM: out["report"], "strict_identity": identity}}


# ---------------------------------------------------------------------------
# duty_cycle: the paper's RQ2 strategies applied to the served int8 engine
# ---------------------------------------------------------------------------
DUTY_LATENCY = {"batch": 4, "prompt_len": 16, "new_tokens": 8}  # measure_latency's defaults
DUTY_SAMPLES = 3                    # measure_latency calls; the profiles take their median
DUTY_GAPS = 40                      # each regular trace: tests/test_serving.py's regimes,
DUTY_SCALES = {"short": 0.05, "long": 20.0}  # gaps of 0.05 and 20 break-even τ
DUTY_BURSTY = 400                   # the seeded bursty trace
DUTY_EXECUTE = {"short": 40, "long": 40, "bursty": 200}  # execute_every: 1, 1, 2 runs a strategy
ADAPTIVE_FLOOR = 0.45               # adaptive's items/J against the best (tests/test_serving.py)
STREAM_GAPS = 1200                  # the streaming policy's run (tests/test_scheduler.py)
STREAM_KW = {"window": 400, "refit_every": 150, "refit_steps": 150}
STREAM_FLOOR = 0.9                  # online items/J against offline learn_tau's
IDLE_SETTLE_S, POWER_LOOP_S = 2.0, 2.5
DRAFT_LENS, DRAFT_BUDGET, DRAFT_PERIOD = (16, 24, 32), 24, 4


def generate_calls(new_tokens: int) -> int:
    """Model calls of one ``generate``: the prefill and one decode step a
    new token."""
    return 1 + new_tokens


def measured_chip(eng, fixed_s: float) -> tuple[dict, object, int]:
    """The three ``AccelProfile`` constants of this engine on the card:
    ``power.draw`` idle, ``power.draw`` during a loop of the ``generate``
    that ``measure_latency`` times, and one pinned host-to-device copy of
    the engine's weight tensors (each copied back into a tensor of its own
    and held bit for bit).  ``fixed_s`` is the ``energy`` phase's library
    load and first launch.  Returns the report, an ``H100Chip`` holding the
    measured constants, and the ``generate`` calls of the loop."""
    chip = DEFAULT_CHIP
    idle = idle_power(IDLE_SETTLE_S)
    prompts = np.zeros((DUTY_LATENCY["batch"], DUTY_LATENCY["prompt_len"]), np.int32)
    busy, loops, loop_s = power_while(
        lambda: eng.generate(prompts, DUTY_LATENCY["new_tokens"]), POWER_LOOP_S)
    if not busy:
        fail("duty_cycle: no power.draw sample during the generate loop")

    tensors = tree_tensors(eng.params)
    nbytes = tree_bytes(eng.params)
    host = [x.cpu().pin_memory() for x in tensors]
    card = [torch.empty_like(x) for x in tensors]

    def reload():
        for c, h in zip(card, host):
            c.copy_(h, non_blocking=True)

    copy_ms = time_ms(reload, reps=1, rounds=5)
    if not all(same_bits(c, x) for c, x in zip(card, tensors)):
        fail("duty_cycle: the reloaded weights differ from the engine's")
    del host, card
    idle_w, active_w = statistics.median(idle), statistics.median(busy)
    copy_s = copy_ms * 1e-3
    default_bytes = 2.0 * eng.cfg.param_count()
    report = {
        "gpu": smi_query("name") + ", " + smi_query("power.limit") + " W",
        "idle_w": r6(idle_w), "idle_samples": idle, "chip_p_idle_w": chip.p_idle_w,
        "active_w": r6(active_w), "active_samples": busy, "chip_p_peak_w": chip.p_peak_w,
        "generate_loop": {"calls": loops, "seconds": r6(loop_s),
                          "call_s": r6(loop_s / loops)},
        "reload": {"weight_tensors": len(tensors), "weight_bytes": nbytes,
                   "pinned_copy_ms": r6(copy_ms), "bytes_per_s": r6(nbytes / copy_s),
                   "library_load_and_first_launch_s": r6(fixed_s),
                   "measured_s": r6(copy_s + fixed_s),
                   "chip_reload_time_s_at_measured_bytes": r6(chip.reload_time(nbytes)),
                   "default_weight_bytes": default_bytes,
                   "gpu_reload_costs_s": r6(engine_mod.gpu_reload_costs(eng.cfg)[0])},
    }
    measured = dataclasses.replace(chip, p_idle_w=idle_w, p_peak_w=active_w,
                                   reload_bw=nbytes / copy_s, reload_fixed_s=fixed_s)
    return report, measured, loops


def stats_dict(stats) -> dict:
    return {**{k: r6(v) if isinstance(v, float) else v
               for k, v in dataclasses.asdict(stats).items()},
            "items_per_joule": r6(stats.items_per_joule)}


def strategy_runs(srv, t_inf: float) -> tuple[dict, int]:
    """``compare_strategies`` under ``srv``'s profile on the regular traces
    at 0.05 and 20 break-even τ and on a seeded bursty trace, the engine
    really run every ``DUTY_EXECUTE`` batches; the reference's orderings
    held.  Returns the report and the ``generate`` calls made."""
    prof = srv.profile(t_inf)
    tau = workload_mod.break_even_tau(prof)
    traces = {k: workload_mod.regular_trace(s * tau + t_inf, t_inf, DUTY_GAPS)
              for k, s in DUTY_SCALES.items()}
    traces["bursty"] = workload_mod.bursty_trace(prof, DUTY_BURSTY, seed=21)
    report, runs = {"profile": {k: r6(v) for k, v in dataclasses.asdict(prof).items()},
                    "break_even_tau_s": r6(tau)}, 0
    for name, gaps in traces.items():
        res = srv.compare_strategies(gaps, t_inf=t_inf, execute_every=DUTY_EXECUTE[name],
                                     **DUTY_LATENCY)
        runs += len(res) * -(-gaps.size // DUTY_EXECUTE[name])
        ipj = {k: v.items_per_joule for k, v in res.items()}
        best = max(ipj.values())
        report[name] = {"gaps": gaps.size, "mean_gap_s": r6(float(gaps.mean())),
                        "best": max(ipj, key=ipj.get),
                        "stats": {k: stats_dict(v) for k, v in res.items()}}
        if name == "short" and ipj["on_off"] > ipj["idle_waiting"]:
            fail(f"duty_cycle: on-off beats idle-waiting at short gaps: {report[name]}")
        if name == "long" and ipj["idle_waiting"] > ipj["on_off"]:
            fail(f"duty_cycle: idle-waiting beats on-off at long gaps: {report[name]}")
        if ipj["adaptive"] < ADAPTIVE_FLOOR * best:
            fail(f"duty_cycle: adaptive under {ADAPTIVE_FLOOR} of the best on {name}: "
                 f"{report[name]}")
    return report, runs


def streaming_tau(prof, dev) -> dict:
    """A ``StreamingTauPolicy`` refitting τ on the card, fed a seeded bursty
    trace; its items/J against offline ``learn_tau`` on the same trace."""
    gaps = workload_mod.bursty_trace(prof, STREAM_GAPS, seed=22)
    pol = policy_mod.StreamingTauPolicy(prof, device=dev, **STREAM_KW)
    if pol.device.type != "cuda":
        fail(f"duty_cycle: the streaming policy refits on {pol.device}")
    t0 = time.perf_counter()
    gap_e = sum(pol.on_gap(float(g)).energy_j for g in gaps)
    online_s = time.perf_counter() - t0
    online = gaps.size / (prof.e_cfg_j + prof.p_active_w * prof.t_inf_s * gaps.size + gap_e)
    tau_off = workload_mod.learn_tau(gaps, prof, device=dev)
    offline = workload_mod.simulate(gaps, "adaptive", prof, tau=tau_off).items_per_joule
    break_even = workload_mod.simulate(gaps, "adaptive", prof,
                                       tau=workload_mod.break_even_tau(prof)).items_per_joule
    report = {"gaps": gaps.size, **STREAM_KW, "refits": pol.refits, "tau_s": r6(pol.tau),
              "tau_offline_s": r6(tau_off),
              "break_even_tau_s": r6(workload_mod.break_even_tau(prof)),
              "online_items_per_joule": r6(online), "offline_items_per_joule": r6(offline),
              "break_even_items_per_joule": r6(break_even),
              "online_over_offline": r6(online / offline), "floor": STREAM_FLOOR,
              "seconds": r6(online_s)}
    if pol.refits != STREAM_GAPS // STREAM_KW["refit_every"] or online < STREAM_FLOOR * offline:
        fail(f"duty_cycle: streaming policy {json.dumps(report)}")
    return report


def drafted_chains(eng, what: str) -> dict:
    """``NgramDrafter`` with a ``SpecThrottle`` over a pool of 4 periodic
    prompts (``load.poisson_stream``'s ``prompt_period``): each tick the
    drafter proposes ``SPEC_K`` tokens a slot, the tick's K is the largest
    window the throttle grants (a plain decode tick when it grants none),
    and ``masked_speculative_step`` verifies them on the replayed verify
    tick.  The emitted chains must equal the plain decode chains of the
    same engine token for token."""
    reqs = load_mod.poisson_stream(4, rate_hz=100.0, seed=23, vocab_size=eng.cfg.vocab_size,
                                   prompt_lens=DRAFT_LENS, new_tokens=(DRAFT_BUDGET,) * 2,
                                   prompt_period=DRAFT_PERIOD)
    plain, vpool = eng.make_pool(), eng.make_pool()
    drafter, throttle = draft_mod.NgramDrafter(SPEC_K), draft_mod.SpecThrottle(SPEC_K)
    want, got = {}, {}
    for s, r in enumerate(reqs):
        first = eng.prefill_into_slot(plain, s, r.prompt, rid=r.rid, budget=r.new_tokens)
        if eng.prefill_into_slot(vpool, s, r.prompt, rid=r.rid, budget=r.new_tokens) != first:
            fail(f"{what}: the same prefill gave another first token")
        want[r.rid], got[r.rid] = [first], [first]
        drafter.begin(r.rid, np.append(r.prompt, first))
        throttle.begin(r.rid)
    while plain.decoding_count:
        live = plain.decoding_slots()
        nxt, fin = eng.masked_decode_step(plain)
        if not fin[live].all():
            fail(f"{what}: a plain decoding slot read non-finite")
        for s in live:
            want[plain.slots[s].rid].append(int(nxt[s]))
            plain.advance(s, 1, int(nxt[s]))
            if plain.slots[s].emitted >= plain.slots[s].budget:
                plain.retire(s)
    ticks = {"verify": 0, "decode": 0}
    fielded = accepted = 0
    while vpool.decoding_count:
        live = vpool.decoding_slots()
        rids = {s: vpool.slots[s].rid for s in live}
        k = max(throttle.window(rids[s]) for s in live)
        if k:
            drafts = np.zeros((vpool.max_batch, k), np.int32)
            for s in live:
                drafts[s] = drafter.propose(rids[s])[:k]
            toks, acc, fin = eng.masked_speculative_step(vpool, drafts)
        else:
            nxt, fin = eng.masked_decode_step(vpool)
            toks, acc = nxt[:, None], np.zeros(vpool.max_batch, np.int32)
        ticks["verify" if k else "decode"] += 1
        if not fin[live].all():
            fail(f"{what}: a drafting slot read non-finite")
        for s in live:
            rid, a, info = rids[s], int(acc[s]), vpool.slots[s]
            emit = [int(x) for x in toks[s, :a + 1][:info.budget - info.emitted]]
            got[rid] += emit
            drafter.observe(rid, emit)
            throttle.observe(rid, a, k)
            fielded, accepted = fielded + k, accepted + a
            if info.emitted + len(emit) >= info.budget:
                vpool.retire(s)
                drafter.forget(rid)
                throttle.forget(rid)
            else:
                vpool.advance(s, a + 1, int(toks[s, a]))
    if got != want:
        first = {rid: next((i for i, (a, b) in enumerate(zip(got[rid], want[rid])) if a != b),
                           None) for rid in want}
        fail(f"{what}: drafted chains differ from plain decode (first difference by request: "
             f"{first}): {got} against {want}")
    graphs = [g for p in (plain, vpool) for g in eng.step_graphs(p).values()]
    return {"requests": len(reqs), "prompt_lens": [int(r.prompt.size) for r in reqs],
            "prompt_period": DRAFT_PERIOD, "budget": DRAFT_BUDGET, "k_max": SPEC_K,
            "ticks": ticks, "graphs": sorted(f"{kind}{k}" for p in (plain, vpool)
                                              for kind, k in eng.step_graphs(p)),
            "drafts_fielded": fielded, "drafts_accepted": accepted,
            "acceptance_rate": r6(accepted / fielded) if fielded else None,
            "tokens_per_request": DRAFT_BUDGET, "chains_equal_plain_decode": True,
            "distinct_tokens": len({t for c in want.values() for t in c}),
            "replayed_int8_matmul": sum(g.replays * g.launches.get("int8_matmul", 0)
                                        for g in graphs)}


def drive_duty_cycle(dev, base, energy: dict) -> dict:
    """The workload-aware server (``WorkloadAwareServer``) on the int8
    engine of ``serve_dense`` (granite-3-8b, 8 layers, ``standard_fan_in``,
    the same weights and ``ServeConfig(max_batch=4, max_len=128)``): the
    measured latency of the eager ``generate``, the three profile constants
    measured on the card (``measured_chip``), the four strategies under the
    chip's profile and the measured one (``strategy_runs``), the streaming
    policy on the card, and the drafter verified on the replayed verify
    tick (an engine of the same weights with ``spec_slack`` = 4)."""
    eng = engine_mod.InferenceEngine(base.cfg, params=base.params, device=dev,
                                     sc=engine_mod.ServeConfig(max_batch=4, max_len=128))
    srv = engine_mod.WorkloadAwareServer(eng)
    samples = [srv.measure_latency(**DUTY_LATENCY) for _ in range(DUTY_SAMPLES)]
    t_inf = statistics.median(samples)
    measured, chip, loops = measured_chip(eng,
                                          energy["reload"]["library_load_and_first_launch_s"])
    msrv = engine_mod.WorkloadAwareServer(eng, chip=chip,
                                          weight_bytes=measured["reload"]["weight_bytes"])
    chip_runs, chip_n = strategy_runs(srv, t_inf)
    measured_runs, measured_n = strategy_runs(msrv, t_inf)
    stream = streaming_tau(msrv.profile(t_inf), dev)
    spec = engine_mod.InferenceEngine(base.cfg, params=base.params, device=dev,
                                      sc=engine_mod.ServeConfig(**ENGINE_SC))
    with CallLog() as log:
        drafting = drafted_chains(spec, "duty_cycle drafter")
    log.check("duty_cycle drafter")
    per_call = k5_per_call(eng.cfg, "decode_step")
    new = DUTY_LATENCY["new_tokens"]
    generate_k5 = per_call * (DUTY_SAMPLES * (generate_calls(2) + generate_calls(new))
                              + (loops + chip_n + measured_n) * generate_calls(new))
    draft_k5 = sum(c["per_call"] for c in log.calls) + drafting["replayed_int8_matmul"]
    report = {
        "arch": GRANITE, "layers": eng.cfg.num_layers, "quant": "int8",
        "serve_config": {"max_batch": 4, "max_len": 128},
        "t_inf_s": r6(t_inf), "t_inf_samples_s": [r6(s) for s in samples],
        "t_inf_is": "WorkloadAwareServer.measure_latency: one eager generate of 4 x 16 zero "
                    "prompts, 8 new tokens, after a warm-up",
        "profile_constants": measured,
        "strategies": {"chip": chip_runs, "measured": measured_runs},
        "streaming_policy": stream, "drafter": drafting,
        "int8_matmul": {"generate_runs": DUTY_SAMPLES * 2 + loops + chip_n + measured_n,
                        "per_call": per_call, "generate": generate_k5, "drafter": draft_k5},
    }
    return {"expect": {"int8_matmul": generate_k5 + draft_k5}, "report": report}


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------
SINGLE_MODES = (False, True, "pallas_step", "pallas_seq", "pallas_seq_q8")
STACK_MODES = ("pallas_stack", "pallas_stack_q8", "pallas_seq", "pallas_seq_q8", "pallas_step",
               False, True)
Q8_VS_F32 = 5e-2   # int8 weights against the f32 path, as the reference's q8 tests


# ---------------------------------------------------------------------------
# The chip model, the block-size tuner and the card's power, on the card
# ---------------------------------------------------------------------------
def check_chip_model(dev) -> dict:
    """``H100Chip``'s data-sheet fields against what the card reports
    (``torch.cuda.get_device_properties``, the cluster kernel's occupancy
    query, ``nvidia-smi``'s power limit).  Fails where a property the card
    reports differs; the memory size may differ by the card's reserve."""
    props = torch.cuda.get_device_properties(dev)
    card = {
        "sms": props.multi_processor_count,
        "smem_per_block": getattr(props, "shared_memory_per_block_optin", None),
        "smem_per_sm": getattr(props, "shared_memory_per_multiprocessor", None),
        "threads_per_sm": getattr(props, "max_threads_per_multi_processor", None),
        "l2_bytes": getattr(props, "L2_cache_size", None),
        "cluster_slots": cluster_slots(dev),
    }
    model = {k: getattr(DEFAULT_CHIP, k) for k in card}
    for k, v in card.items():
        if v is not None and v != model[k]:
            fail(f"H100Chip.{k} = {model[k]}, the card reports {v}")
    total = props.total_memory
    if abs(total - DEFAULT_CHIP.hbm_bytes) > 0.1 * DEFAULT_CHIP.hbm_bytes:
        fail(f"H100Chip.hbm_bytes = {DEFAULT_CHIP.hbm_bytes}, the card has {total}")
    limit = float(smi_query("power.limit"))
    return {"card": card, "model": model, "total_memory": total,
            "hbm_bytes": DEFAULT_CHIP.hbm_bytes, "power_limit_w": limit,
            "p_peak_w": DEFAULT_CHIP.p_peak_w, "runtime": {
                "MAX_SHARED_BYTES": runtime.MAX_SHARED_BYTES, "SM_COUNT": runtime.SM_COUNT}}


def smi_query(field: str) -> str:
    """One ``nvidia-smi --query-gpu`` field of card 0, without units."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def fixed_int8_plan(m: int, k: int, n: int) -> dict:
    """K5's geometry before the tuner (the fixed rule it replaced, passed to
    the wrapper explicitly to compare with): 16-row tiles at decode, K split
    until the grid holds 2 x 132 blocks; 64- or 128-row tiles above, K split
    while the tiles leave SMs idle, chunks of at least 8 stages."""
    if m <= 16:
        block_m, target, min_steps = 16, 2 * runtime.SM_COUNT, 1
        block_n = 128 if n >= 4096 else 64
    elif m <= 64:
        block_m, block_n, target, min_steps = 64, 128, runtime.SM_COUNT, 8
    else:
        block_m, block_n, target, min_steps = 128, 128, runtime.SM_COUNT, 8
    steps = -(-k // int8_mod.BLOCK_K)
    tiles = -(-m // block_m) * -(-n // block_n)
    per = max(steps // -(-target // tiles), min(min_steps, steps), 1)
    return {"block_m": block_m, "block_n": block_n, "block_k": per * int8_mod.BLOCK_K}


def tuner_cases() -> list[tuple]:
    """(kernel, problem, dtype, fixed plan, tolerance, main path?): every
    K2-K6 shape of the main paths, and the chunked LSTM batch of 200 rows,
    where the tuner leaves the fixed plan.  The fixed plans are those of
    the rules the tuner replaced."""
    lw = paper_workload()
    paper = {"batch": PAPER_BATCH, "seq": lw.seq, "d_in": lw.d_in, "hidden": lw.hidden}
    b, s, d, h = QUANT_SHAPE
    wide = {"batch": b, "seq": s, "d_in": d, "hidden": h}
    chunky = dict(zip(("batch", "seq", "d_in", "hidden"), CHUNK_SHAPE))
    cases = [("lstm_cell", {"batch": b, "d_in": d, "hidden": h}, "float32", {"block_b": 10},
              TOL_F32, True),
             ("lstm_cell", {"batch": PAPER_BATCH, "d_in": lw.d_in, "hidden": lw.hidden},
              "float32", {"block_b": 2}, TOL_F32, True)]
    for dtype, tol in (("float32", TOL_F32), ("int8", TOL_Q8)):
        cases += [("lstm_seq", wide, dtype, {"block_b": 3}, tol, True),
                  ("lstm_seq", paper, dtype, {"block_b": 1}, tol, True),
                  ("lstm_seq", chunky, dtype, {"block_b": 14}, tol, False),
                  ("lstm_stack", {**wide, "layers": STACK_SHAPE[4]}, dtype, {"block_b": 3}, tol,
                   True),
                  ("lstm_stack", {**chunky, "layers": STACK_SHAPE[4]}, dtype, {"block_b": 14},
                   tol, False)]
    for m in (4, 20, 32, 64, 256):
        for k, n in INT8_PROJ_KN:
            cases.append(("int8_matmul", {"m": m, "k": k, "n": n}, "int8",
                          fixed_int8_plan(m, k, n), 0.0, True))
    # the expert einsums, one launch over E: the fixed plan is the one the
    # rule gives a single product of the shape (a split of K that fills the
    # card for one product, over-split when E products share the grid)
    for e, m, k, n, _ in INT8_BATCHED:
        cases.append(("int8_matmul", {"m": m, "k": k, "n": n, "batch": e}, "int8",
                      fixed_int8_plan(m, k, n), 0.0, True))
    # whisper-tiny's and internvl2-76b's projections at the row counts their
    # paths launch: decode (4), whisper's encoder over one and four requests'
    # 1500 frames; internvl2's verify (4 x 5), a chunk of 2 x 48, one prompt
    # of 320 positions and four
    for ms, kns in ((WHISPER_K5_M, WHISPER_K5_KN), (VLM_K5_M, VLM_K5_KN)):
        for m in ms:
            for k, n in kns:
                cases.append(("int8_matmul", {"m": m, "k": k, "n": n}, "int8",
                              fixed_int8_plan(m, k, n), 0.0, True))
    fb, fh, _, fsq, fsk, fd, _, _ = FLASH_MAIN
    flash = {"b": fb, "h": fh, "sq": fsq, "sk": fsk, "d": fd}
    cases += [("flash_attention", flash, "bfloat16", {"block_q": 64, "block_k": 64}, TOL_BF16,
               True)]
    return cases


TUNER_TOP = 6    # analytic candidates timed beside the pick and the fixed plan


def tuner_case(dev, kernel, problem, dtype, fixed, tol, main_path) -> dict:
    """One shape: the analytic pick and the fixed plan (device times taken
    in turns, pick, plan, plan, pick, pick, plan, and the median of each),
    the analytic top ``TUNER_TOP`` and the probes, the measured refinement
    over the top 3 (``bench.make_measure_fn``), each output held to the
    plain version, and the tuner's own host time with a cold disk cache, a
    warm process and a warm disk.  K5 is timed with its weight read from
    device memory (``cold_device_ms``), as the serving path reads it."""
    from repro_torch.kernels import autotune

    chip = autotune.chip_with_slots(cluster_slots(dev) if kernel.startswith("lstm_s") else None)
    backend = runtime.CUDA_BACKEND
    autotune.clear_cache(disk=True)
    t0 = time.perf_counter()
    pick = autotune.autotune(kernel, problem, dtype=dtype, backend=backend, chip=chip)
    t1 = time.perf_counter()
    autotune.autotune(kernel, problem, dtype=dtype, backend=backend, chip=chip)
    t2 = time.perf_counter()
    autotune.clear_cache()
    autotune.autotune(kernel, problem, dtype=dtype, backend=backend, chip=chip)
    t3 = time.perf_counter()
    ranked = autotune.ranked_candidates(kernel, problem, dtype=dtype, chip=chip)
    if ranked[0] != pick:
        fail(f"tuner {kernel} {problem}: autotune gave {pick}, the ranking {ranked[0]}")
    run, plain = bench.candidate_calls(kernel, problem, dtype, dev, seed=500)
    timer = lambda c: device_ms(run(c), reps=5)  # noqa: E731
    if kernel == "int8_matmul":  # from device memory, as the serving path reads its weights
        m, k, n, e = problem["m"], problem["k"], problem["n"], problem.get("batch")
        xq, wq, sx, sw = (batched_int8_operands(e, m, k, n, dev, 500, False) if e
                          else int8_operands(m, k, n, dev, 500))
        run = lambda c: lambda: (int8_matmul(xq, wq, sx, sw, **c),)  # noqa: E731
        plain = lambda: (int8_matmul_plain(xq, wq, sx, sw),)  # noqa: E731
        timer = lambda c: cold_device_ms(lambda w: int8_matmul(xq, w, sx, sw, **c), wq)  # noqa: E731
    want = plain()

    def checked(c):
        got = run(c)()
        err = max(compare(g, w, "exact", tol, f"tuner {kernel} {problem} {dtype} {c}")
                  if tol else exact(g, w, f"tuner {kernel} {problem} {c}")
                  for g, w in zip(got, want))
        return err

    timed = []
    for c in [pick, fixed] + ranked[:TUNER_TOP] + tuner_probes(kernel, problem, ranked):
        if c not in timed:
            timed.append(c)
    rows = {}
    for c in timed:
        rows[json.dumps(c, sort_keys=True)] = {
            "candidate": c, "max_abs_err": r6(checked(c)),
            "predicted_us": r6(autotune.predict_time_s(kernel, problem, c, dtype=dtype,
                                                       chip=chip) * 1e6),
            "device_ms": r6(timer(c))}
    turns = {"pick": [], "fixed": []}
    for side in ("pick", "fixed", "fixed", "pick", "pick", "fixed"):
        t = timer(pick if side == "pick" else fixed)
        if t is not None:
            turns[side].append(t)
    pick_ms = statistics.median(turns["pick"]) if turns["pick"] else None
    fixed_ms = statistics.median(turns["fixed"]) if turns["fixed"] else None
    measured = autotune.autotune(kernel, problem, dtype=dtype, backend=backend, chip=chip,
                                 measure_fn=bench.make_measure_fn(kernel, problem, dtype, dev),
                                 top_k=3)
    measured_key = json.dumps(measured, sort_keys=True)
    if measured_key not in rows:
        fail(f"tuner {kernel} {problem}: measured winner {measured} not among the top 3")
    autotune.clear_cache(disk=True)
    return {"kernel": kernel, "problem": problem, "dtype": dtype, "main_path": main_path,
            "tolerance": tol, "pick": pick, "fixed": fixed, "same_as_fixed": pick == fixed,
            "pick_device_ms": r6(pick_ms), "fixed_device_ms": r6(fixed_ms),
            "pick_over_fixed": r6(None if None in (pick_ms, fixed_ms) else pick_ms / fixed_ms),
            "measured_winner": measured, "measured_device_ms": rows[measured_key]["device_ms"],
            "autotune_us": {"cold": r6((t1 - t0) * 1e6), "warm": r6((t2 - t1) * 1e6),
                            "disk": r6((t3 - t2) * 1e6)},
            "candidates": list(rows.values())}


def tuner_summary(tuner: dict) -> dict:
    """The ``tuner`` line: each case without its candidate table (which
    ``--out`` keeps)."""
    return {**tuner, "cases": [{k: v for k, v in c.items() if k != "candidates"}
                               for c in tuner["cases"]]}


TUNER_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def tuner_probes(kernel, problem, ranked) -> list[dict]:
    """Candidates timed besides the analytic top, so that the fit in the
    ``tuner`` line sees the whole range: K5's tiles at 1 to 32 chunks of K
    (those the tuner takes), and every LSTM tile that fits up to 16 rows."""
    from repro_torch.kernels import autotune

    if kernel == "int8_matmul":
        steps = -(-problem["k"] // int8_mod.BLOCK_K)
        tiles = sorted({(c["block_m"], c["block_n"]) for c in ranked})
        chunks = set(autotune.k_chunks(problem["k"]))
        probes = [{"block_m": bm, "block_n": bn, "block_k": -(-steps // s) * int8_mod.BLOCK_K}
                  for bm, bn in tiles for s in TUNER_SPLITS if s <= steps]
        return [c for c in probes if c["block_k"] in chunks]
    if kernel.startswith("lstm"):
        return [c for c in ranked if c["block_b"] <= 16]
    return []


def nonnegative_lstsq(a: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with every coefficient >= 0: features whose coefficient
    comes out negative are dropped and the rest refitted."""
    keep = np.ones(a.shape[1], dtype=bool)
    while True:
        x = np.zeros(a.shape[1])
        x[keep] = np.linalg.lstsq(a[:, keep], y, rcond=None)[0]
        if (x >= 0).all():
            return x
        keep &= x > 0


def tuner_fit(cases) -> dict:
    """The tuner's linear fits (``autotune.features``) refitted to this
    run's timings, relative error minimised, beside the committed fit."""
    from repro_torch.kernels import autotune

    groups: dict[str, list] = {}
    for case in cases:
        chip = autotune.chip_with_slots(
            DEFAULT_CHIP.cluster_slots if case["kernel"].startswith("lstm_s") else None)
        for row in case["candidates"]:
            f = autotune.features(case["kernel"], case["problem"], row["candidate"],
                                  dtype=case["dtype"], chip=chip)
            if f is not None and row["device_ms"]:
                groups.setdefault(f[0], []).append((f[1], row["device_ms"] * 1e-3))
    out = {}
    for name, rows in sorted(groups.items()):
        a = np.array([r[0] for r in rows], dtype=np.float64)
        y = np.array([r[1] for r in rows])
        refit = nonnegative_lstsq(a / y[:, None], np.ones(len(y)))
        committed = np.array(autotune.FITS[name])
        rms = lambda x: float(np.sqrt(np.mean(((a @ x - y) / y) ** 2)))  # noqa: E731
        out[name] = {"samples": len(rows), "refit": [float(f"{v:.4g}") for v in refit],
                     "committed": [float(f"{v:.4g}") for v in committed],
                     "rms_rel_refit": r6(rms(refit)), "rms_rel_committed": r6(rms(committed))}
    return out


def exact(got, want, what: str) -> float:
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"{what}: not bit-identical to the plain version")
    return 0.0


def check_tuner(dev) -> dict:
    """Every case of :func:`tuner_cases` in a cache directory of its own,
    which is removed after, so that no measured winner reaches the paths
    driven later (their "auto" is the analytic pick)."""
    import os
    import tempfile

    from repro_torch.kernels import autotune

    saved = os.environ.get("REPRO_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_AUTOTUNE_CACHE"] = str(pathlib.Path(tmp) / "autotune.json")
        try:
            cases = [tuner_case(dev, *case) for case in tuner_cases()]
        finally:
            autotune.clear_cache()
            if saved is None:
                os.environ.pop("REPRO_AUTOTUNE_CACHE")
            else:
                os.environ["REPRO_AUTOTUNE_CACHE"] = saved
    main = [c for c in cases if c["main_path"] and c["pick_over_fixed"] is not None]
    return {"model": autotune.MODEL, "fit": tuner_fit(cases), "cases": cases,
            "main_path_shapes": len(main),
            "same_as_fixed": sum(c["same_as_fixed"] for c in main),
            "worst_pick_over_fixed": r6(max(c["pick_over_fixed"] for c in main)),
            "over_1_03": [[c["kernel"], c["problem"], c["dtype"], c["pick_over_fixed"]]
                          for c in main if c["pick_over_fixed"] > 1.03]}


ENERGY_LOOP_S = 2.0


def sample_power(stop, out: list, period: float = 0.1) -> None:
    while not stop.is_set():
        out.append(float(smi_query("power.draw")))
        stop.wait(period)


def idle_power(settle_s: float) -> list[float]:
    """``power.draw`` of the idle card (its context held): 10 samples 0.2 s
    apart, after ``settle_s`` seconds of nothing."""
    torch.cuda.synchronize()
    time.sleep(settle_s)
    idle = []
    for _ in range(10):
        idle.append(float(smi_query("power.draw")))
        time.sleep(0.2)
    return idle


def power_while(fn, seconds: float) -> tuple[list, int, float]:
    """``power.draw`` samples (``sample_power``'s thread) while ``fn`` runs
    back to back for at least ``seconds``; returns the samples, the calls
    and the seconds."""
    import threading

    busy, stop = [], threading.Event()
    sampler = threading.Thread(target=sample_power, args=(stop, busy))
    calls, t0 = 0, time.perf_counter()
    sampler.start()
    try:
        while time.perf_counter() - t0 < seconds:
            fn()
            calls += 1
    finally:
        stop.set()
        sampler.join()
    return busy, calls, time.perf_counter() - t0


def measure_energy(dev) -> dict:
    """``power.draw`` of the idle card and during a 2 s loop of K3 at
    ``QUANT_SHAPE`` (f32), beside ``H100Chip.step_power`` at that loop's
    utilisation (its operations over the f32 peak); the L2 rate (a 16 MB
    device copy, read + write); and the two "configuration" constants: a
    pinned host-to-device copy of one ``serve_dense`` layer's int8
    projections, and, in a fresh process, loading the built kernel library
    plus a first launch."""
    chip = DEFAULT_CHIP
    idle = idle_power(3.0)
    b, s, d, h = QUANT_SHAPE
    x, params = make_lstm(70, b, s, d, h, 1, dev)
    p = params[0]
    fn = lambda: lstm_seq_fused(x, p["w"], p["u"], p["b"])  # noqa: E731
    fn()
    torch.cuda.synchronize()

    def burst():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()

    busy, bursts, loop_s = power_while(burst, ENERGY_LOOP_S)
    calls = 50 * bursts
    call_ms = loop_s / calls * 1e3
    util = lstm_flops(b, s, d, h) / (call_ms * 1e-3) / PEAK_F32_FLOPS
    # L2: 8 MB read and 8 MB written per copy, both within the 50 MB L2
    src = torch.empty(8 << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    l2_ms = time_ms(lambda: dst.copy_(src), reps=200)
    # one serve_dense layer's int8 projections, pinned, to the card
    cfg = get_config(GRANITE)
    hd = cfg.resolved_head_dim
    layer_bytes = cfg.d_model * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd \
        + cfg.num_heads * hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff
    host = torch.empty(layer_bytes, dtype=torch.uint8).pin_memory()
    card = torch.empty(layer_bytes, dtype=torch.uint8, device=dev)
    copy_ms = time_ms(lambda: card.copy_(host, non_blocking=True), reps=5, rounds=5)
    del host, card
    probe = ("import sys, time, torch; sys.path.insert(0, 'src');"
             "from repro_torch.kernels import runtime;"
             "from repro_torch.kernels.activations import activation;"
             "x = torch.zeros(1024, device='cuda'); torch.cuda.synchronize();"
             "t0 = time.perf_counter(); runtime.load_kernels(); activation(x);"
             "torch.cuda.synchronize(); print(time.perf_counter() - t0)")
    root = pathlib.Path(__file__).resolve().parent
    fixed_s = float(subprocess.run([sys.executable, "-c", probe], cwd=root, capture_output=True,
                                   text=True, check=True, timeout=120).stdout.strip())
    idle_w = statistics.median(idle)
    busy_w = statistics.median(busy) if busy else None
    return {"gpu": smi_query("name") + ", " + smi_query("power.limit") + " W",
            "idle_w": r6(idle_w), "idle_samples": idle,
            "k3_loop": {"shape": list(QUANT_SHAPE), "seconds": r6(loop_s), "calls": calls,
                        "call_ms": r6(call_ms), "utilisation_f32": r6(util),
                        "power_draw_w": r6(busy_w), "samples": len(busy),
                        "step_power_w": r6(chip.step_power(util)),
                        "energy_per_call_mj": r6(None if busy_w is None else busy_w * call_ms)},
            "l2_copy": {"bytes_moved": 2 * src.numel(), "ms": r6(l2_ms),
                        "bytes_per_s": r6(2 * src.numel() / (l2_ms * 1e-3))},
            "reload": {"layer_bytes": layer_bytes, "pinned_copy_ms": r6(copy_ms),
                       "bytes_per_s": r6(layer_bytes / (copy_ms * 1e-3)),
                       "library_load_and_first_launch_s": r6(fixed_s)},
            "model": {"p_idle_w": chip.p_idle_w, "p_peak_w": chip.p_peak_w,
                      "reload_bw": chip.reload_bw, "reload_fixed_s": chip.reload_fixed_s}}


def drive_main_path(dev) -> dict:
    """The paper-LSTM plan, then request batches through every mode.  Returns
    the launch counts it expects, and what it saw."""
    b, s, d, h = QUANT_SHAPE
    sb, ss, sd, sh, sl = STACK_SHAPE
    expect = {k: 0 for k in ("activation", "lstm_cell", "lstm_seq_f32", "lstm_seq_q8",
                             "lstm_stack_f32", "lstm_stack_q8")}
    plan = plan_paper_lstm(batch=PAPER_BATCH, device=dev)
    timed = 1 + 15  # compare_lstm_paths: one warm-up and n=15 samples per path
    expect["lstm_seq_f32"] += 1 + timed
    expect["lstm_cell"] += timed * plan["seq"]

    _, single = make_lstm(1000, b, s, d, h, 1, dev)
    _, stack = make_lstm(1001, sb, ss, sd, sh, sl, dev)
    worst = {}
    for req in range(REQUESTS):
        x = torch.from_numpy(
            np.random.default_rng(2000 + req).standard_normal((b, s, d)).astype(np.float32)).to(dev)
        want = lstm_apply(single[0], x, fused=True)
        for mode in SINGLE_MODES:
            got = lstm_apply(single[0], x, fused=mode)
            if got.shape != (b, s, h):
                fail(f"lstm_apply {mode}: shape {tuple(got.shape)}")
            tol = Q8_VS_F32 if mode == "pallas_seq_q8" else TOL_F32
            key = f"lstm_apply/{mode}"
            worst[key] = max(worst.get(key, 0.0), compare(got, want, "exact", tol, key))
        expect["lstm_cell"] += s
        expect["lstm_seq_f32"] += 1
        expect["lstm_seq_q8"] += 1

        want = lstm_stack_apply(stack, x, fused=True)
        for mode in STACK_MODES:
            got = lstm_stack_apply(stack, x, fused=mode)
            if got.shape != (sb, ss, sh):
                fail(f"lstm_stack_apply {mode}: shape {tuple(got.shape)}")
            tol = Q8_VS_F32 if str(mode).endswith("q8") else TOL_F32
            key = f"lstm_stack_apply/{mode}"
            worst[key] = max(worst.get(key, 0.0), compare(got, want, "exact", tol, key))
        expect["lstm_stack_f32"] += 1          # one launch, not L
        expect["lstm_stack_q8"] += 1
        expect["lstm_seq_f32"] += sl
        expect["lstm_seq_q8"] += sl
        expect["lstm_cell"] += sl * ss

        # the gate nonlinearities of the request's output, every variant (RQ1)
        for fn in ("sigmoid", "tanh", "silu", "gelu"):
            for impl in IMPLS:
                y = ops.activation(want, fn=fn, impl=impl)
                ref = activation_plain(want, fn=fn, impl=impl)
                key = f"activation/{impl}"
                worst[key] = max(worst.get(key, 0.0),
                                 compare(y, ref, impl, TOL_F32, key, same_inputs=True))
                expect["activation"] += 1
    torch.cuda.synchronize()
    return {"expect": expect, "plan": plan, "worst": {k: r6(v) for k, v in worst.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the report to this JSON file")
    ap.add_argument("--parent", default=None, type=pathlib.Path,
                    help="a checkout of the parent commit (git archive): its lstm_cell kernel "
                         "is built and timed beside this one's")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # f32 means f32: no TF32 in any product of a plain version or of cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([runtime._find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    release = next((ln.strip() for ln in nvcc.splitlines() if "release" in ln), "unknown")
    env = {"python": sys.version.split()[0], "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvcc": release, "gpu": smi, "allow_tf32": False,
           "cudnn_allow_tf32": False}
    print("env " + json.dumps(env), flush=True)
    print(smi, flush=True)
    runtime.load_kernels()
    sass = sass_tensor_ops()
    sass_summary = None if sass is None else {
        family: {"op": op, "instantiations": sum(c["family"] == family for c in sass.values()),
                 "fewest": min(c["count"] for c in sass.values() if c["family"] == family)}
        for family, op in TENSOR_CORE_KERNELS.items()}
    print("build " + json.dumps({"seconds": r6(runtime.build_seconds()),
                                 "library": "build/repro_torch", "sources": sorted(
                                     p.name for p in runtime.CSRC_DIR.glob("*.cu")),
                                 "sass_tensor_ops": sass_summary}), flush=True)

    warm_card(dev)  # after the build, which leaves the card idle
    phases: dict[str, float] = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phases[name] = r6(time.perf_counter() - t0)
        print("phase " + json.dumps({"name": name, "seconds": phases[name]}), flush=True)
        return out

    kernels = [phase("activation", check_activation, dev),
               phase("lstm_cell", check_cell, dev, args.parent),
               phase("lstm_seq_f32", check_seq, dev, False),
               phase("lstm_seq_q8", check_seq, dev, True),
               phase("lstm_stack_f32", check_stack, dev, False),
               phase("lstm_stack_q8", check_stack, dev, True),
               phase("int8_matmul", check_int8_matmul, dev),
               phase("flash_attention", check_flash, dev)]
    host = phase("host_path", host_path, dev)
    chip_model = phase("chip_model", check_chip_model, dev)
    tuner = phase("tuner", check_tuner, dev)
    energy = phase("energy", measure_energy, dev)
    quantize_on_card = phase("quantize_on_card", check_quantize_on_card, dev)
    init_on_card = phase("init_on_card", check_init_on_card, dev)

    # Each path runs with the counters set to 0 just before it and read just
    # after; a kernel's "launches" are those of the path it belongs to.
    driven, counts_by_path, k5_seen = {}, {}, {}
    paths = {"lstm": drive_main_path, "serve_dense": drive_serve_dense,
             "serve_engine": lambda d: drive_serve_engine(d, driven["serve_dense"]["engine"]),
             "duty_cycle": lambda d: drive_duty_cycle(d, driven["serve_dense"]["engine"], energy),
             "serve_moe": drive_serve_moe, "serve_ssm": drive_serve_ssm,
             "serve_audio": drive_serve_audio, "serve_vlm": drive_serve_vlm,
             "flash_attention": drive_flash_path}
    for name, drive in paths.items():
        runtime.reset_launch_counts()
        with k5_shapes_recorded(k5_seen, name):
            driven[name] = phase(f"path:{name}", drive, dev)
        counts_by_path[name] = runtime.launch_counts()
    k5_entry = next(k for k in kernels if k["name"] == "int8_matmul")
    path_shapes = phase("int8_path_shapes", check_int8_path_shapes, dev, k5_seen)
    k5_entry["path_shapes"] = {k: v for k, v in path_shapes.items() if k not in ("legend", "shapes")}
    k5_entry["path_shapes"]["bitwise_equal"] = len(path_shapes["shapes"])
    for k in kernels:
        on = [p for p in paths if k["name"] in driven[p]["expect"]]
        k["launches_by_path"] = {p: counts_by_path[p].get(k["name"], 0) for p in on}
        for path in on:
            launches, want = k["launches_by_path"][path], driven[path]["expect"][k["name"]]
            if launches < 1:
                fail(f"the {path} path never launched {k['name']}")
            if launches != want:
                fail(f"{k['name']}: {launches} launches on the {path} path, {want} expected")
        k["path"] = on[0]
        k["launches"] = k["launches_by_path"][on[0]]
    counts = counts_by_path["lstm"]
    serve = driven["serve_dense"]["report"]
    serve["launches"] = counts_by_path["serve_dense"]
    serve["quantize_on_card"] = quantize_on_card
    serve["init_on_card"] = init_on_card
    dense_engine = driven["serve_dense"].pop("engine")
    serve["block_card_vs_cpu"] = phase("block_card_vs_cpu", check_block_card_vs_cpu,
                                       dense_engine, dev)
    serve["profile"] = phase("serve_profile", profile_serve, dense_engine, dev)
    del dense_engine
    engine_report = driven["serve_engine"]["report"]
    engine_report["launches"] = counts_by_path["serve_engine"]
    engine_report["ticks"] = phase("serve_engine_ticks", time_engine_ticks,
                                   driven["serve_engine"])
    for key in ("engine", "pools", "drafts"):
        driven["serve_engine"].pop(key)
    duty_report = driven["duty_cycle"]["report"]
    duty_report["launches"] = counts_by_path["duty_cycle"]
    duty_report["t_inf_beside_the_replayed_tick"] = {
        "t_inf_s": duty_report["t_inf_s"],
        "model_calls_of_t_inf": generate_calls(DUTY_LATENCY["new_tokens"]),
        "replayed_decode_tick_ms_median": engine_report["ticks"]["tick_ms_median"][
            "decode_replayed"],
        "eager_decode_tick_ms_median": engine_report["ticks"]["tick_ms_median"]["decode_eager"],
        "profile_uses": "t_inf_s (eager generate)"}
    moe_report = driven["serve_moe"]["report"]
    moe_report["launches"] = counts_by_path["serve_moe"]
    ssm_report = driven["serve_ssm"]["report"]
    ssm_report["launches"] = counts_by_path["serve_ssm"]
    audio_report = driven["serve_audio"]["report"]
    audio_report["launches"] = counts_by_path["serve_audio"]
    vlm_report = driven["serve_vlm"]["report"]
    vlm_report["launches"] = counts_by_path["serve_vlm"]
    driven = driven["lstm"]

    lw = paper_workload()
    medians_us = phase("lstm_bench", lambda: {
        "paths_paper": bench.compare_lstm_paths(PAPER_BATCH, lw.seq, lw.d_in, lw.hidden, device=dev),
        "paths_scaled": bench.compare_lstm_paths(*SCALED_SHAPE, device=dev),
        "quant": bench.compare_lstm_quant(*QUANT_SHAPE, device=dev),
        "stack_f32": bench.compare_lstm_stack(*STACK_SHAPE, device=dev),
        "stack_q8": bench.compare_lstm_stack(*STACK_SHAPE, quantized=True, device=dev),
    })
    main_path = {
        "requests": REQUESTS, "shape": list(QUANT_SHAPE), "stack_shape": list(STACK_SHAPE),
        "plan_paper_lstm": {k: (r6(v) if isinstance(v, float) else v)
                            for k, v in driven["plan"].items()},
        "launches": counts, "max_abs_err_vs_fused_true": driven["worst"],
        "tolerance": {"f32": TOL_F32, "q8_vs_f32": Q8_VS_F32},
        "medians_us": {k: [r6(a), r6(b)] for k, (a, b) in medians_us.items()},
        "medians_us_legend": {
            "paths_*": "[sequence kernel, per-step kernel loop]",
            "quant": "[f32 sequence kernel, int8 sequence kernel]",
            "stack_*": "[layer-fused stack, L sequential sequence kernels]"},
        "phase_seconds": phases, "seconds": r6(time.perf_counter() - t_start),
    }
    main_path["trace_check"] = TRACE_CHECK
    report = {"env": env, "kernels": kernels, "main_path": main_path, "serve_dense": serve,
              "serve_engine": engine_report, "duty_cycle": duty_report,
              "serve_moe": moe_report, "serve_ssm": ssm_report,
              "serve_audio": audio_report, "serve_vlm": vlm_report,
              "int8_path_shapes": path_shapes, "host_path": host,
              "chip_model": chip_model,
              "tuner": tuner, "energy": energy,
              "lut_seen": {k: {n: r6(v) for n, v in d.items()} for k, d in LUT_SEEN.items()},
              "tensor_core_kernels": {"ptxas": ptxas_usage(runtime.compile_log()),
                                      "sass": sass,
                                      "flash_bf16_dynamic_smem_bytes": {
                                          d: flash_smem_bytes(d) for d in HEAD_DIMS}},
              "nvcc_log": runtime.compile_log()}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))

    print("serve_dense " + json.dumps(serve), flush=True)
    print("serve_engine " + json.dumps(engine_report), flush=True)
    print("serve_moe " + json.dumps(moe_report), flush=True)
    print("serve_ssm " + json.dumps(ssm_report), flush=True)
    print("serve_audio " + json.dumps(audio_report), flush=True)
    print("serve_vlm " + json.dumps(vlm_report), flush=True)
    print("duty_cycle " + json.dumps(duty_report), flush=True)
    print("int8_path_shapes " + json.dumps(path_shapes), flush=True)
    print("host_path " + json.dumps(host), flush=True)
    print("chip_model " + json.dumps(chip_model), flush=True)
    print("tuner " + json.dumps(tuner_summary(tuner)), flush=True)
    print("energy " + json.dumps(energy), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print("main_path " + json.dumps(main_path), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
