"""Activation-function implementation variants (paper RQ1).

The paper's RTL templates provide several hardware implementations per
activation function, trading precision against resources and energy:

  exact — transcendental (highest precision)
  pwl   — the PLAN piecewise-linear approximation (compares and FMAs)
  lut   — 256-entry table lookup over a clamped input range
  hard  — HardSigmoid/HardTanh (min/max only)

These definitions are the *semantics*, value for value those of
``repro.models.activations``.  ``repro_torch.kernels.activations`` holds the
CUDA kernel of the same variants; note that the kernels compute the exact
tanh as 2·sigmoid(2x) − 1, while ``tanh_exact`` here is ``torch.tanh``.
"""
from __future__ import annotations

import functools

import torch

LUT_SIZE = 256
LUT_RANGE = 8.0  # inputs clamped to [-8, 8]


# -- sigmoid variants --------------------------------------------------------
def sigmoid_exact(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def sigmoid_pwl(x: torch.Tensor) -> torch.Tensor:
    """PLAN approximation (Amin et al.), symmetric around 0."""
    a = x.abs()
    y = torch.where(
        a >= 5.0,
        torch.ones_like(a),
        torch.where(
            a >= 2.375,
            0.03125 * a + 0.84375,
            torch.where(a >= 1.0, 0.125 * a + 0.625, 0.25 * a + 0.5),
        ),
    )
    return torch.where(x >= 0, y, 1.0 - y).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _table_on(device: torch.device) -> torch.Tensor:
    # Grid points i·(1/255)·8 in f32 with the end point set to exactly 8: the
    # reference's linspace arithmetic, so that the two tables are equal bit
    # for bit (torch.linspace rounds about half of the points differently).
    step = torch.tensor(1.0 / (LUT_SIZE - 1), dtype=torch.float32)
    grid = torch.arange(LUT_SIZE, dtype=torch.float32) * step * LUT_RANGE
    grid[-1] = LUT_RANGE
    return torch.sigmoid(grid).to(device)


def _sigmoid_table(device=None) -> torch.Tensor:
    """Half-range table: σ on [0, 8].  σ(−x) = 1 − σ(x) halves the table and
    makes the implementation exactly point-symmetric; grid step 8/255 bounds
    the nearest-neighbour error at max σ'·h/2 ≈ 3.93e-3.  Built on the CPU
    (one set of values for every device) and cached per device."""
    return _table_on(torch.device("cpu" if device is None else device))


def sigmoid_lut(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    a = xf.abs().clamp(0.0, LUT_RANGE)
    idx = torch.round(a / LUT_RANGE * (LUT_SIZE - 1)).to(torch.int64)  # half to even
    y = _sigmoid_table(x.device)[idx]
    return torch.where(xf >= 0, y, 1.0 - y).to(x.dtype)


def sigmoid_hard(x: torch.Tensor) -> torch.Tensor:
    # relu6(x+3)/6 — matches the paper's HardSigmoid RTL template
    return ((x + 3.0).clamp(0.0, 6.0) / 6.0).to(x.dtype)


# -- tanh variants (derived: tanh(x) = 2·sigmoid(2x) − 1) --------------------
def tanh_exact(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def tanh_pwl(x: torch.Tensor) -> torch.Tensor:
    return (2.0 * sigmoid_pwl(2.0 * x) - 1.0).to(x.dtype)


def tanh_lut(x: torch.Tensor) -> torch.Tensor:
    return (2.0 * sigmoid_lut(2.0 * x) - 1.0).to(x.dtype)


def tanh_hard(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-1.0, 1.0)


_SIGMOID = {"exact": sigmoid_exact, "pwl": sigmoid_pwl, "lut": sigmoid_lut, "hard": sigmoid_hard}
_TANH = {"exact": tanh_exact, "pwl": tanh_pwl, "lut": tanh_lut, "hard": tanh_hard}


def get_sigmoid(impl: str):
    return _SIGMOID[impl]


def get_tanh(impl: str):
    return _TANH[impl]


def get_activation(family: str, impl: str = "exact"):
    """MLP nonlinearity under a given implementation variant.

    silu(x) = x·sigmoid(x); gelu approximated via tanh form so every variant
    axis applies uniformly.
    """
    if family == "silu":
        sig = get_sigmoid(impl)
        return lambda x: x * sig(x)
    if family == "gelu":
        th = get_tanh(impl)
        c = 0.7978845608028654  # sqrt(2/pi)
        return lambda x: 0.5 * x * (1.0 + th(c * (x + 0.044715 * x * x * x)))
    if family == "relu":
        return torch.relu
    raise ValueError(f"unknown activation family {family!r}")


# Relative elementwise cost weights per variant (ops per element), from op
# counts: exact sigmoid = exp + add + div ≈ 12; pwl = 6 (compare chain + FMA);
# lut = 4 (clamp, scale, round, gather); hard = 3 (clip, FMA).
VARIANT_COST = {"exact": 12.0, "pwl": 6.0, "lut": 4.0, "hard": 3.0}
# Max abs error vs. exact over [-8, 8] (measured in tests, documented here).
# lut: half-range 256-entry grid + reflection, h=8/255 → max σ'·h/2 ≈ 3.93e-3.
VARIANT_ERROR = {"exact": 0.0, "pwl": 2.45e-2, "lut": 4.0e-3, "hard": 1.27e-1}
