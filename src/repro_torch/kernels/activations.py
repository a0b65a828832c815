"""The activation-implementation variants (RQ1) as one CUDA kernel.

  exact — expf and an IEEE division
  pwl   — PLAN piecewise-linear: compare chain + FMA
  lut   — 256-entry half-range table in shared memory, indexed load, sign
          reflection (the reference gathers with a one-hot product; same
          values, other mechanism)
  hard  — clip + FMA only

The kernel (``csrc/activations.cu``) walks the flattened tensor; there is no
row tile, so the reference's ``block_rows`` argument has no counterpart and
nothing is padded.  ``csrc/activations.cuh`` holds ``apply_variant``, the
device function that the LSTM kernels call in their epilogues.

:func:`activation_plain` is the plain PyTorch version of the same
arithmetic: f32 whatever the storage type, tanh as 2σ(2x) − 1 (``hard`` tanh
is clip(x, −1, 1)).  The wrapper takes it only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.models.activations import LUT_RANGE, LUT_SIZE, _sigmoid_table

IMPL_CODES = {"exact": 0, "pwl": 1, "lut": 2, "hard": 3}
FN_CODES = {"sigmoid": 0, "tanh": 1, "silu": 2, "gelu": 3}


def impl_code(impl: str) -> int:
    if impl not in IMPL_CODES:
        raise ValueError(f"unknown activation impl {impl!r}; expected one of {sorted(IMPL_CODES)}")
    return IMPL_CODES[impl]


def _sigmoid_exact(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _sigmoid_pwl(x):
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
    return torch.where(x >= 0, y, 1.0 - y)


def _sigmoid_hard(x):
    return (x + 3.0).clamp(0.0, 6.0) / 6.0


def _lut_lookup(x, table):
    a = x.abs().clamp(0.0, LUT_RANGE)
    idx = torch.round(a / LUT_RANGE * (LUT_SIZE - 1)).to(torch.int64)  # half to even
    y = table[idx]
    return torch.where(x >= 0, y, 1.0 - y)


def apply_variant_plain(x: torch.Tensor, impl: str, fn: str) -> torch.Tensor:
    """``apply_variant`` of ``csrc/activations.cuh`` in plain PyTorch; f32
    in and out, ``fn`` is "sigmoid" or "tanh"."""
    xf = x.to(torch.float32)
    is_tanh = fn == "tanh"
    arg = 2.0 * xf if is_tanh else xf  # tanh(x) = 2σ(2x) − 1
    if impl == "exact":
        s = _sigmoid_exact(arg)
    elif impl == "pwl":
        s = _sigmoid_pwl(arg)
    elif impl == "hard":
        if is_tanh:
            return xf.clamp(-1.0, 1.0)
        s = _sigmoid_hard(arg)
    elif impl == "lut":
        s = _lut_lookup(arg, _sigmoid_table(x.device))
    else:
        raise ValueError(f"unknown activation impl {impl!r}")
    return 2.0 * s - 1.0 if is_tanh else s


def activation_plain(x: torch.Tensor, *, fn: str = "sigmoid", impl: str = "exact") -> torch.Tensor:
    """Plain PyTorch version of the kernel: same arithmetic, any device."""
    if fn not in FN_CODES:
        raise ValueError(f"unknown activation fn {fn!r}; expected one of {sorted(FN_CODES)}")
    impl_code(impl)
    xf = x.to(torch.float32)
    if fn == "silu":
        y = xf * apply_variant_plain(xf, impl, "sigmoid")
    elif fn == "gelu":
        c = 0.7978845608028654
        inner = c * (xf + 0.044715 * xf * xf * xf)
        y = 0.5 * xf * (1.0 + apply_variant_plain(inner, impl, "tanh"))
    else:
        y = apply_variant_plain(xf, impl, fn)
    return y.to(x.dtype)


# (fn, impl) -> the kernel's two codes; unknown names are refused by name.
_CODES = {(fn, impl): (f, i) for fn, f in FN_CODES.items() for impl, i in IMPL_CODES.items()}
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_LUT = IMPL_CODES["lut"]


def table_pointer(dev: torch.device, code: int) -> int:
    """Address of the sigmoid table on ``dev`` for the ``lut`` variant, 0
    for the others (their kernels never read it)."""
    return _sigmoid_table(dev).data_ptr() if code == _LUT else 0


def activation(x: torch.Tensor, *, fn: str = "sigmoid", impl: str = "exact") -> torch.Tensor:
    """Elementwise activation variant.  x: any shape, f32 or bf16, contiguous;
    returns the same shape and type (arithmetic in f32).

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    :func:`activation_plain`.
    """
    codes = _CODES.get((fn, impl))
    if codes is None:
        if fn not in FN_CODES:
            raise ValueError(f"unknown activation fn {fn!r}; expected one of {sorted(FN_CODES)}")
        impl_code(impl)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return activation_plain(x, fn=fn, impl=impl)
    is_bf16 = _IS_BF16.get(x.dtype)
    if is_bf16 is None:
        raise TypeError(f"activation kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("activation kernel takes a contiguous tensor")
    y = torch.empty_like(x)
    f, i = codes
    runtime.launch("activation", "repro_activation", x.get_device(), x.data_ptr(), y.data_ptr(),
                   x.numel(), f, i, is_bf16, table_pointer(x.device, i) if i == _LUT else 0)
    return y
