"""The card's peaks and the least time a piece of work could take on it (the
yardstick of ``model_mfu``, ``model_hbm_share`` and ``int8_matmul_roofline``).
Published peaks of one H100 SXM (NVIDIA's data sheet, dense): 1,979 TOP/s
int8, 3.35 TB/s of HBM.

What a model's served work needs (its K5 launches, operations and bytes)
is counted by its own module under ``perfbench/models/``.
"""
from __future__ import annotations

PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float) -> float:
    """Least time the card could take (frozen from ``chip_smoke.bound``):
    the larger of bytes over the memory rate and operations over the int8
    peak (both operands of the projections are int8)."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT8_OPS)


def k5_call_bound_s(m: int, k: int, n: int, batch: int, shared: bool) -> float:
    """One ``int8_matmul`` launch's bound: x and its row scales (once when
    shared), the weights and their column scales, the f32 output, each
    counted once."""
    xb = 1 if shared else batch
    nbytes = xb * m * (k + 4) + batch * (k * n + 4 * n) + batch * m * n * 4
    return bound_s(nbytes, 2.0 * m * k * n * batch)
