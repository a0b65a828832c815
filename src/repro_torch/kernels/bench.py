"""Shared micro-benchmark harness for the LSTM kernel mappings, on the card.

Competing paths are sampled INTERLEAVED, so that clock and power drift hit
each equally, and the median per-call time is reported.  Each sample is one
call bracketed by CUDA events, followed by ``torch.cuda.synchronize()``; a
warm-up call per path (which also builds the kernels) stays outside the
timed region.  Used by ``repro_torch.launch.train --paper-lstm`` and by
``chip_smoke.py`` so the methodology cannot drift between the two.

These functions measure a device and therefore need one: ``device=None``
means the card, and a CPU device is refused.  The empirical ``measure_fn``
for the block-size tuner arrives with the tuner.
"""
from __future__ import annotations

import statistics

import torch

from repro_torch.kernels.runtime import resolve_device


def _timing_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the bench harness times CUDA events and needs a CUDA device")
    return dev


def _interleaved_medians_us(fns, n: int):
    """Median per-call µs for each thunk, sampled round-robin."""
    for fn in fns:  # warm-up (and kernel build) outside the timed region
        fn()
    torch.cuda.synchronize()
    samples = [[] for _ in fns]
    for _ in range(n):
        for out, fn in zip(samples, fns):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(stop) * 1e3)  # ms → µs
    return [statistics.median(s) for s in samples]


def _f32(tree):
    from repro_torch.models.params import tree_map

    return tree_map(lambda t: t.to(torch.float32), tree)


def _lstm_inputs(batch: int, seq: int, d_in: int, hidden: int, device, layers: int | None = None):
    from repro_torch.models.lstm import lstm_defs, lstm_stack_defs
    from repro_torch.models.params import init_params

    gen = torch.Generator().manual_seed(0)
    defs = lstm_defs(d_in, hidden) if layers is None else lstm_stack_defs(d_in, hidden, layers)
    params = _f32(init_params(defs, gen, device))
    x = torch.randn((batch, seq, d_in), generator=gen, dtype=torch.float32).to(device)
    return params, x


def compare_lstm_paths(batch: int, seq: int, d_in: int, hidden: int,
                       *, n: int = 33, impl: str = "exact", device=None):
    """Median per-call µs of (sequence kernel, per-step cell kernel under a
    Python loop): one launch against S."""
    from repro_torch.models.lstm import lstm_apply

    dev = _timing_device(device)
    params, x = _lstm_inputs(batch, seq, d_in, hidden, dev)
    t_seq, t_step = _interleaved_medians_us(
        [lambda: lstm_apply(params, x, impl=impl, fused="pallas_seq"),
         lambda: lstm_apply(params, x, impl=impl, fused="pallas_step")], n,
    )
    return t_seq, t_step


def compare_lstm_quant(batch: int, seq: int, d_in: int, hidden: int,
                       *, n: int = 33, impl: str = "exact", device=None):
    """Median per-call µs of (f32 ``pallas_seq``, int8 ``pallas_seq_q8``) at
    EQUAL (B, S, D, H).

    The int8 path runs over pre-quantized weights (quantization is a
    one-time deployment cost, outside the timed region).
    """
    from repro_torch.kernels.lstm_quant import quantize_lstm_weights
    from repro_torch.kernels.lstm_seq import lstm_seq_fused, lstm_seq_fused_quantized

    dev = _timing_device(device)
    params, x = _lstm_inputs(batch, seq, d_in, hidden, dev)
    qw = quantize_lstm_weights(params["w"], params["u"], params["b"], hidden)
    t_f32, t_q8 = _interleaved_medians_us(
        [lambda: lstm_seq_fused(x, params["w"], params["u"], params["b"], impl=impl),
         lambda: lstm_seq_fused_quantized(x, qw, impl=impl)], n,
    )
    return t_f32, t_q8


def compare_lstm_stack(batch: int, seq: int, d_in: int, hidden: int,
                       layers: int, *, n: int = 33, impl: str = "exact",
                       quantized: bool = False, device=None):
    """Median per-call µs of (layer-fused stack, L sequential ``lstm_seq``
    calls) — same weights, same recurrence, one launch vs L."""
    from repro_torch.kernels.lstm_seq import lstm_seq_fused, lstm_stack_fused

    dev = _timing_device(device)
    params, x = _lstm_inputs(batch, seq, d_in, hidden, dev, layers=layers)

    def sequential():
        h = x
        for p in params:
            h = lstm_seq_fused(h, p["w"], p["u"], p["b"], impl=impl)
        return h

    t_stack, t_seq = _interleaved_medians_us(
        [lambda: lstm_stack_fused(x, params, impl=impl, quantized=quantized), sequential], n,
    )
    return t_stack, t_seq
