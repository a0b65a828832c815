"""LSTM layer — the paper's flagship accelerator target (refs [2,5,20]).

The RTL-template story maps onto execution paths selected by the ``fused``
argument of :func:`lstm_apply`.  The mode strings are the JAX package's, so
that calls and tests map one to one; **here the ``"pallas_*"`` modes name the
hand-written CUDA kernels** of ``repro_torch.kernels``:

  False          — four separate gate products + separate activation calls
                   per step in plain PyTorch; the "minimal-ALU,
                   reuse-over-time" baseline design the paper compares
                   against.
  True           — one (D, 4H) and one (H, 4H) product for all gates per
                   step in plain PyTorch, S steps from a Python loop; the
                   paper's pipelined template left to the framework.
  "pallas_step"  — the same loop, but each step is ONE launch of the fused
                   cell kernel (``kernels.lstm_cell``): S launches, weights
                   re-read every step (the benchmark baseline and
                   decode-style primitive).
  "pallas_seq"   — ONE launch for the whole sequence (``kernels.lstm_seq``):
                   the time loop runs inside the kernel and h/c never leave
                   the chip. Preferred full-sequence path.
  "pallas_seq_q8" — the same kernel over int8 weights with per-gate-column
                   scales (``kernels.lstm_quant``): the paper's precision
                   axis composed with its residency axis.

Multi-layer stacks go through :func:`lstm_stack_apply`, whose
``fused="pallas_stack"``/``"pallas_stack_q8"`` modes chain all L layers in
one launch with the inter-layer h sequence kept inside it (in shared memory,
or on the cluster path in a workspace that stays in L2) —
replacing the Python-level per-layer loop (still available as the baseline:
any single-layer ``fused`` mode loops layer by layer).

All paths honour the activation-implementation axis (RQ1): sigmoid/tanh in
{exact, pwl, lut, hard} variants from ``repro_torch.models.activations``.
Everything runs where its tensors lie; the kernels take f32 only, so cast
parameters made from the bf16 ``ParamDef`` default before a kernel mode.
"""
from __future__ import annotations

import torch

from repro_torch.models.activations import get_sigmoid, get_tanh
from repro_torch.models.params import ParamDef

PALLAS_PATHS = ("pallas_seq", "pallas_seq_q8", "pallas_step")
STACK_FUSED_MODES = ("pallas_stack", "pallas_stack_q8")


def lstm_defs(d_in: int, hidden: int) -> dict:
    return {
        "w": ParamDef((d_in, 4 * hidden), ("embed", "mlp")),
        "u": ParamDef((hidden, 4 * hidden), (None, "mlp")),
        "b": ParamDef((4 * hidden,), ("mlp",), init="zeros"),
    }


def lstm_cell(params, x_t, h, c, *, impl: str = "exact", fused: bool = True):
    """One LSTM step. x_t: (B, D_in); h, c: (B, H). Gate order: i, f, g, o."""
    sig, tnh = get_sigmoid(impl), get_tanh(impl)
    hidden = h.shape[-1]
    if fused:
        z = x_t @ params["w"] + h @ params["u"] + params["b"].to(x_t.dtype)
        zi, zf, zg, zo = z.chunk(4, dim=-1)
    else:  # four independent products (minimal-ALU baseline template)
        outs = []
        for k in range(4):
            cols = slice(k * hidden, (k + 1) * hidden)
            outs.append(x_t @ params["w"][:, cols] + h @ params["u"][:, cols]
                        + params["b"][cols].to(x_t.dtype))
        zi, zf, zg, zo = outs
    i, f, o = sig(zi), sig(zf), sig(zo)
    g = tnh(zg)
    c_new = f * c + i * g
    h_new = o * tnh(c_new)
    return h_new, c_new


def _check_fused_mode(fused, allowed, what: str):
    """Single up-front gate for every string ``fused`` mode — unknown modes
    fail HERE, before any early return can route past the check."""
    if isinstance(fused, str) and fused not in allowed:
        known = ", ".join(repr(m) for m in allowed)
        raise ValueError(f"unknown {what} fused mode {fused!r}; expected one of "
                         f"{{False, True, {known}}}")


def lstm_apply(params, x, *, impl: str = "exact", fused: bool | str = True,
               block_b: int | str = "auto"):
    """Full-sequence LSTM. x: (B, S, D_in) → (B, S, H).

    ``fused`` selects the execution path (see the module docstring):

      False           four separate gate products per step, plain PyTorch
      True            one fused gate product pair per step, plain PyTorch
      "pallas_step"   per-step cell kernel from a Python loop (S launches)
      "pallas_seq"    ONE launch of the sequence kernel, f32 weights
      "pallas_seq_q8" the sequence kernel over int8 weights

    Any other string raises ``ValueError`` (checked up-front, before any
    path dispatch). ``block_b`` only applies to the kernel paths.
    """
    _check_fused_mode(fused, PALLAS_PATHS, "lstm_apply")
    if fused in ("pallas_seq", "pallas_seq_q8"):
        from repro_torch.kernels import ops

        op = ops.lstm_seq if fused == "pallas_seq" else ops.lstm_seq_q8
        return op(x, params["w"], params["u"], params["b"], impl=impl, block_b=block_b)

    b = x.shape[0]
    hidden = params["u"].shape[0]
    h = torch.zeros((b, hidden), dtype=x.dtype, device=x.device)
    c = torch.zeros((b, hidden), dtype=x.dtype, device=x.device)

    if fused == "pallas_step":
        from repro_torch.kernels import ops

        # resolve "auto" once, before the step loop (the tuner reads its cache)
        if block_b == "auto":
            from repro_torch.kernels.autotune import autotune
            from repro_torch.kernels.runtime import backend_key

            block_b = autotune("lstm_cell", {"batch": b, "d_in": x.shape[2], "hidden": hidden},
                               dtype="float32", backend=backend_key(x.device))["block_b"]

        def step(x_t, h, c):
            return ops.lstm_cell(x_t, h, c, params["w"], params["u"], params["b"],
                                 impl=impl, block_b=block_b)
    else:
        def step(x_t, h, c):
            return lstm_cell(params, x_t, h, c, impl=impl, fused=fused)

    xt = x.transpose(0, 1).contiguous()  # time-major once, so each x_t is contiguous
    hs = []
    for t in range(xt.shape[0]):
        h, c = step(xt[t], h, c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def lstm_stack_defs(d_in: int, hidden: int, layers: int) -> list[dict]:
    """ParamDef tree for an L-layer stack: layer 0 projects d_in → H, the
    rest H → H (a list of per-layer ``lstm_defs`` dicts)."""
    if layers < 1:
        raise ValueError(f"layers must be >= 1, got {layers}")
    return [lstm_defs(d_in if l == 0 else hidden, hidden) for l in range(layers)]


def lstm_stack_apply(params, x, *, impl: str = "exact",
                     fused: bool | str = "pallas_stack",
                     block_b: int | str = "auto"):
    """L-layer LSTM stack. x: (B, S, D_in) → last layer's hs (B, S, H).

    ``params`` is the list from :func:`lstm_stack_defs`.  ``fused``:

      "pallas_stack"     ONE launch chains all L layers; the inter-layer h
                         sequence stays inside the launch (preferred)
      "pallas_stack_q8"  the same with every layer's weights int8
      anything accepted by :func:`lstm_apply` — the Python-level per-layer
                         loop baseline (L separate calls)
    """
    _check_fused_mode(fused, STACK_FUSED_MODES + PALLAS_PATHS, "lstm_stack_apply")
    if fused in STACK_FUSED_MODES:
        from repro_torch.kernels import ops

        return ops.lstm_stack(
            x, params, impl=impl, block_b=block_b,
            quantized=(fused == "pallas_stack_q8"),
        )
    h = x
    for layer in params:
        h = lstm_apply(layer, h, impl=impl, fused=fused, block_b=block_b)
    return h
