"""Shared micro-benchmark harness for the LSTM kernel mappings, on the card.

Competing paths are sampled INTERLEAVED, so that clock and power drift hit
each equally, and the median per-call time is reported.  Each sample is one
call bracketed by CUDA events, followed by ``torch.cuda.synchronize()``; a
warm-up call per path (which also builds the kernels) stays outside the
timed region.  Used by ``repro_torch.launch.train --paper-lstm`` and by
``chip_smoke.py`` so the methodology cannot drift between the two.

These functions measure a device and therefore need one: ``device=None``
means the card, and a CPU device is refused.  The one exception is
:func:`make_measure_fn`, the block-size tuner's empirical ``measure_fn``,
which on the CPU times the kernels' plain versions so that the tests can
drive the tuner's measured refinement; on the card it times the kernels.
"""
from __future__ import annotations

import statistics
import time

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


def candidate_calls(kernel: str, problem: dict, dtype: str = "float32", device=None, *,
                    impl: str = "exact", seed: int = 0):
    """Inputs for ``kernel`` at ``problem`` (``kernels.autotune``'s problem
    dicts and dtypes), made once from a seeded ``torch.Generator`` on
    ``device``, and two functions of them: ``run(candidate)``, a thunk that
    runs the kernel's wrapper at that candidate's geometry, and ``plain()``,
    the kernel's plain PyTorch version on the same inputs.  Both return the
    output as a tuple of tensors (an LSTM sequence: its hs)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain
    from repro_torch.kernels.lstm_cell import lstm_cell_fused, lstm_cell_plain
    from repro_torch.kernels.lstm_quant import quantize_lstm_stack
    from repro_torch.kernels.lstm_seq import (
        _lstm_seq_call, _lstm_stack_call, lstm_seq_plain, lstm_stack_plain,
    )
    from repro_torch.kernels.ref import quantize_colwise, quantize_rowwise

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen, dtype=torch.float32).to(dev)  # noqa: E731
    quantized = "int8" in dtype

    if kernel == "lstm_cell":
        b, d, h = problem["batch"], problem["d_in"], problem["hidden"]
        params, _ = _lstm_inputs(b, 1, d, h, dev)
        args = (randn(b, d), torch.tanh(randn(b, h)), randn(b, h),
                params["w"], params["u"], params["b"])
        return (lambda c: lambda: lstm_cell_fused(*args, impl=impl, block_b=c["block_b"]),
                lambda: lstm_cell_plain(*args, impl=impl))
    if kernel in ("lstm_seq", "lstm_stack"):
        b, s, d, h = problem["batch"], problem["seq"], problem["d_in"], problem["hidden"]
        layers = problem.get("layers")
        params, x = _lstm_inputs(b, s, d, h, dev, layers=layers)
        params = params if layers else [params]
        if quantized:  # quantized once, as a deployment holds them
            operands = [(q.w_q, q.u_q, q.b, q.w_scale, q.u_scale)
                        for q in quantize_lstm_stack(params)]
        else:
            operands = [(p["w"], p["u"], p["b"], None, None) for p in params]
        if layers:
            return (lambda c: lambda: (_lstm_stack_call(
                        x, operands, impl=impl, block_b=c["block_b"], return_state=False,
                        packed=quantized),),
                    lambda: lstm_stack_plain(x, operands, impl=impl, packed=quantized)[:1])
        return (lambda c: lambda: (_lstm_seq_call(
                    x, *operands[0], impl=impl, block_b=c["block_b"], return_state=False,
                    packed=quantized),),
                lambda: lstm_seq_plain(x, *operands[0], impl=impl, packed=quantized)[:1])
    if kernel == "int8_matmul":
        m, k, n, e = problem["m"], problem["k"], problem["n"], problem.get("batch")
        if e:  # E products: their own rows, one weight copied E times on the device
            xq, sx = quantize_rowwise(randn(e * m, k))
            xq, sx = xq.reshape(e, m, k), sx.reshape(e, m, 1)
            wq, sw = (t.expand(e, *t.shape).contiguous()
                      for t in quantize_colwise(randn(k, n)))
        else:
            xq, sx = quantize_rowwise(randn(m, k))
            wq, sw = quantize_colwise(randn(k, n))
        return (lambda c: lambda: (int8_matmul(xq, wq, sx, sw, block_m=c["block_m"],
                                               block_n=c["block_n"], block_k=c["block_k"]),),
                lambda: (int8_matmul_plain(xq, wq, sx, sw),))
    if kernel == "flash_attention":
        b, h, sq, sk, d = (problem[f] for f in ("b", "h", "sq", "sk", "d"))
        kind = torch.bfloat16 if "bfloat16" in dtype else torch.float32
        q, kk, v = randn(b, h, sq, d).to(kind), randn(b, h, sk, d).to(kind), randn(b, h, sk, d).to(kind)
        return (lambda c: lambda: (flash_attention(q, kk, v, causal=True, block_q=c["block_q"],
                                                   block_k=c["block_k"]),),
                lambda: (flash_attention_plain(q, kk, v, causal=True),))
    raise ValueError(f"no empirical measure for kernel {kernel!r}")


def make_measure_fn(kernel: str, problem: dict, dtype: str = "float32", device=None, *,
                    impl: str = "exact", n: int = 5):
    """Build the block-size tuner's empirical ``measure_fn`` (candidate →
    seconds) for ``kernel`` at ``problem`` (``kernels.autotune``'s problem
    dicts and dtypes): inputs made once from a seeded ``torch.Generator``
    (:func:`candidate_calls`), then, for each candidate, the kernel run at
    that candidate's geometry and its median per-call time over ``n``
    samples (CUDA events, the interleaved medians above; a warm-up call
    first).

    This is step 3 of the Generator method: analytical pruning picks the
    top-k, timing on the card ranks the survivors.  ``device="cpu"`` times
    the plain PyTorch versions with the host clock instead; their time does
    not depend on the candidate, so that is for tests only."""
    dev = resolve_device(device)
    run, _ = candidate_calls(kernel, problem, dtype, dev, impl=impl)

    def measure(candidate: dict) -> float:
        fn = run(candidate)
        if dev.type == "cuda":
            return _interleaved_medians_us([fn], max(n, 1))[0] * 1e-6
        fn()
        samples = []
        for _ in range(max(n, 1)):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
        return statistics.median(samples)

    return measure
