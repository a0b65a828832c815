#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds every CUDA kernel of ``src/repro_torch/csrc`` from source, holds each
against its plain PyTorch version on the card at the shapes the LSTM
inference path uses, times kernel, plain version and (where one PyTorch call
computes the same function) the library, then drives the main path — the
paper-LSTM plan and request batches through ``lstm_apply`` and
``lstm_stack_apply`` in every mode — and checks outputs and launch counts.

Lines printed, in order: ``env``, the card as ``nvidia-smi`` names it,
``build``, one JSON object ``{"kernels": [...]}``, ``main_path``, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is then
not 0 and the last line is not printed.  ``--out FILE`` also writes the whole
report as JSON.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.core.fpga import paper_workload  # noqa: E402
from repro_torch.kernels import bench, ops, runtime  # noqa: E402
from repro_torch.kernels.activations import activation, activation_plain  # noqa: E402
from repro_torch.kernels.lstm_cell import lstm_cell_fused, lstm_cell_plain  # noqa: E402
from repro_torch.kernels.lstm_quant import quantize_lstm_stack, quantize_lstm_weights  # noqa: E402
from repro_torch.kernels.lstm_seq import (  # noqa: E402
    lstm_seq_fused, lstm_seq_fused_quantized, lstm_seq_plain, lstm_stack_fused, lstm_stack_plain,
    plan_launch,
)
from repro_torch.launch.train import plan_paper_lstm  # noqa: E402
from repro_torch.models.lstm import lstm_apply, lstm_stack_apply  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and the f32 rate outside the tensor cores, which is what these kernels use.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

IMPLS = ("exact", "pwl", "lut", "hard")
PAPER_BATCH = 64
SCALED_SHAPE = (32, 64, 16, 32)            # (B, S, D, H)
QUANT_SHAPE = (40, 28, 256, 256)
STACK_SHAPE = (40, 28, 256, 256, 3)        # (B, S, D, H, L)
RAGGED_BATCH = 33
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


def device_ms(fn, reps: int = 10):
    """GPU-busy time of one call in ms: the device time of every kernel the
    call launches, from the profiler's trace, without the host's share.
    ``None`` if the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back empty; ask again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages())
        if total_us > 0:
            return total_us / reps / 1e3
    return None


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time the card could take, in ms, and which limit sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
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
        shapes.append({
            "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": max(errs.values()), "err_by_impl": {
                impl: r6(max(v for k, v in errs.items() if k.endswith(impl))) for impl in IMPLS},
            "tolerance": tol,
            "ms": r6(time_ms(lambda: activation(x, fn="sigmoid", impl="exact"))),
            "device_ms": r6(device_ms(lambda: activation(x, fn="sigmoid", impl="exact"))),
            "plain_ms": r6(time_ms(lambda: activation_plain(x, fn="sigmoid", impl="exact"))),
            "library_ms": r6(time_ms(lambda: torch.sigmoid(x))),
            "ms_by_fn_exact": {fn: r6(time_ms(lambda: activation(x, fn=fn, impl="exact"), reps=10,
                                              rounds=3)) for fn in library},
            "library_ms_by_fn": {fn: r6(time_ms(lambda: call(x), reps=10, rounds=3))
                                 for fn, call in library.items()},
            "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    return entry("activation", "src/repro_torch/csrc/activations.cu",
                 "src/repro/kernels/activations.py:118", shapes)


def check_cell(dev):
    lw = paper_workload()
    cases = [QUANT_SHAPE, (PAPER_BATCH, lw.seq, lw.d_in, lw.hidden), SCALED_SHAPE,
             (RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden)]
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
        shapes.append({
            "shape": [batch, d_in, hidden], "max_abs_err": max(errs.values()),
            "err_by_impl": {k: r6(v) for k, v in errs.items()}, "tolerance": TOL_F32,
            "ms": r6(time_ms(lambda: lstm_cell_fused(*args))),
            "device_ms": r6(device_ms(lambda: lstm_cell_fused(*args))),
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
        torch.cuda.synchronize()
        library_ms = lib_err = None
        if not quantized:
            lstm = torch.nn.LSTM(d_in, hidden, batch_first=True, device=dev)
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(p["w"].t()); lstm.weight_hh_l0.copy_(p["u"].t())
                lstm.bias_ih_l0.copy_(p["b"]); lstm.bias_hh_l0.zero_()
                lib_err = float((lstm(x)[0] - kernel()).abs().max())
                library_ms = time_ms(lambda: lstm(x))
        plan = plan_launch("auto", batch, seq, d_in, hidden, quantized=quantized)
        weights = [t for t in operands if t is not None]
        out_bytes = 4 * (batch * seq * hidden + 2 * batch * hidden)
        bound_ms, bound_by = bound(nbytes(x, *weights) + out_bytes,
                                   lstm_flops(batch, seq, d_in, hidden))
        shapes.append({
            "shape": [batch, seq, d_in, hidden], "block_b": plan.block_b,
            "weights": "shared memory" if plan.resident else "re-read from L2 each step",
            "smem_bytes": plan.smem_bytes, "max_abs_err": max(errs.values()),
            "err_by_impl": {k: r6(v) for k, v in errs.items()}, "tolerance": tol,
            "ms": r6(time_ms(kernel)), "device_ms": r6(device_ms(kernel)),
            "ms_by_impl": {impl: r6(time_ms(lambda: kernel(impl), reps=10, rounds=3))
                           for impl in IMPLS},
            "plain_ms": r6(time_ms(lambda: lstm_seq_plain(x, *operands, packed=quantized),
                                   reps=3, rounds=3)),
            "library_ms": r6(library_ms), "library_max_abs_diff": r6(lib_err),
            "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    return entry(name, "src/repro_torch/csrc/lstm_seq.cu",
                 "src/repro/kernels/lstm_seq.py:245", shapes)


def check_stack(dev, quantized: bool):
    lw = paper_workload()
    cases = [STACK_SHAPE, (PAPER_BATCH, lw.seq, lw.d_in, lw.hidden, 3),
             (RAGGED_BATCH, SCALED_SHAPE[1], SCALED_SHAPE[2], SCALED_SHAPE[3], 2)]
    tol = TOL_Q8 if quantized else TOL_F32
    name = "lstm_stack_q8" if quantized else "lstm_stack_f32"
    shapes = []
    for batch, seq, d_in, hidden, layers in cases:
        x, params = make_lstm(30 + len(shapes), batch, seq, d_in, hidden, layers, dev)
        if quantized:
            qs = quantize_lstm_stack(params)
            operands = (qs[0].w_q, torch.stack([q.w_q for q in qs[1:]]),
                        torch.stack([q.u_q for q in qs]), torch.stack([q.b for q in qs]),
                        torch.stack([q.w_scale for q in qs]), torch.stack([q.u_scale for q in qs]))
        else:
            operands = (params[0]["w"], torch.stack([p["w"] for p in params[1:]]),
                        torch.stack([p["u"] for p in params]),
                        torch.stack([p["b"] for p in params]), None, None)
        kernel = lambda impl="exact", **kw: lstm_stack_fused(x, params, impl=impl,
                                                              quantized=quantized, **kw)
        errs = {}
        for impl in IMPLS:
            hs, (hn, cn) = kernel(impl, return_state=True)
            want = lstm_stack_plain(x, *operands, impl=impl, packed=quantized)
            errs[impl] = max(compare(g, w, impl, tol, f"{name} {batch, seq, d_in, hidden, layers}")
                             for g, w in zip((hs, hn, cn), want))
        hs3 = kernel(block_b=3)  # a tile that does not divide the batch
        compare(hs3, lstm_stack_plain(x, *operands, packed=quantized)[0], "exact", tol,
                f"{name} block_b=3")
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
        plan = plan_launch("auto", batch, seq, d_in, hidden, layers=layers, quantized=quantized)
        weights = [t for t in operands if t is not None]
        out_bytes = 4 * (batch * seq * hidden + 2 * layers * batch * hidden)
        bound_ms, bound_by = bound(nbytes(x, *weights) + out_bytes,
                                   lstm_flops(batch, seq, d_in, hidden, layers))
        shapes.append({
            "shape": [batch, seq, d_in, hidden, layers], "block_b": plan.block_b,
            "weights": "shared memory" if plan.resident else "re-read from L2 each step",
            "smem_bytes": plan.smem_bytes, "max_abs_err": max(errs.values()),
            "err_by_impl": {k: r6(v) for k, v in errs.items()}, "tolerance": tol,
            "ms": r6(time_ms(kernel)), "device_ms": r6(device_ms(kernel)),
            "plain_ms": r6(time_ms(lambda: lstm_stack_plain(x, *operands, packed=quantized),
                                   reps=2, rounds=3)),
            "library_ms": r6(library_ms), "library_max_abs_diff": r6(lib_err),
            "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    return entry(name, "src/repro_torch/csrc/lstm_seq.cu",
                 "src/repro/kernels/lstm_seq.py:368", shapes)


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------
SINGLE_MODES = (False, True, "pallas_step", "pallas_seq", "pallas_seq_q8")
STACK_MODES = ("pallas_stack", "pallas_stack_q8", "pallas_seq", "pallas_seq_q8", "pallas_step",
               False, True)
Q8_VS_F32 = 5e-2   # int8 weights against the f32 path, as the reference's q8 tests


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
    print("build " + json.dumps({"seconds": r6(runtime.build_seconds()),
                                 "library": "build/repro_torch", "sources": sorted(
                                     p.name for p in runtime.CSRC_DIR.glob("*.cu"))}), flush=True)

    kernels = [check_activation(dev), check_cell(dev), check_seq(dev, False),
               check_seq(dev, True), check_stack(dev, False), check_stack(dev, True)]

    runtime.reset_launch_counts()
    driven = drive_main_path(dev)
    counts = runtime.launch_counts()
    for k in kernels:
        k["launches"] = counts.get(k["name"], 0)
        if k["launches"] < 1:
            fail(f"the main path never launched {k['name']}")
        if k["launches"] != driven["expect"][k["name"]]:
            fail(f"{k['name']}: {k['launches']} launches on the main path, "
                 f"{driven['expect'][k['name']]} expected")

    lw = paper_workload()
    medians_us = {
        "paths_paper": bench.compare_lstm_paths(PAPER_BATCH, lw.seq, lw.d_in, lw.hidden, device=dev),
        "paths_scaled": bench.compare_lstm_paths(*SCALED_SHAPE, device=dev),
        "quant": bench.compare_lstm_quant(*QUANT_SHAPE, device=dev),
        "stack_f32": bench.compare_lstm_stack(*STACK_SHAPE, device=dev),
        "stack_q8": bench.compare_lstm_stack(*STACK_SHAPE, quantized=True, device=dev),
    }
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
        "seconds": r6(time.perf_counter() - t_start),
    }
    report = {"env": env, "kernels": kernels, "main_path": main_path,
              "lut_seen": {k: {n: r6(v) for n, v in d.items()} for k, d in LUT_SEEN.items()},
              "nvcc_log": runtime.compile_log()}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": kernels}), flush=True)
    print("main_path " + json.dumps(main_path), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
