"""Roofline arithmetic on the H100 (the Generator's estimation stage).

The paper's Generator prunes candidates with *analytical models* before any
expensive evaluation (§2.2).  This module is the roofline core of that
model for the card, as the block-size tuner (``kernels/autotune.py``) uses
it:

  compute term    = operations / the peak rate of the operands' type
  memory term     = device-memory bytes / HBM bandwidth
  collective term = bytes between cards / NVLink bandwidth each way

T_step = max(terms) (perfect overlap; the sum is the no-overlap bound, both
reported).  Energy = T_step · chips · P(util), with the linear idle→peak
power model of ``core.energy.H100Chip``.

Unlike the TPU, whose matrix unit runs f32 products through its bf16 path,
the H100 runs IEEE f32 multiply-adds on its CUDA cores at 67 TFLOP/s, a
fifteenth of the bf16 tensor-core rate: :func:`chip_for_dtype` scores f32
work against that rate.  The reference's per-architecture step estimates
and mesh plans (its ``TPUCostBackend``, ``estimate_step``, ``MeshPlan``)
are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.energy import DEFAULT_CHIP, H100Chip

BF16 = 2  # bytes
F32 = 4
INT8 = 1

# Bytes per element for the dtype strings that flow through the kernel layer
# (tuner cache keys use the dtype's name; quantized paths use "int8").
DTYPE_BYTES = {
    "float64": 8,
    "float32": F32,
    "float16": 2,
    "bfloat16": BF16,
    "int8": INT8,
    "int32": 4,
}


def dtype_bytes(dtype: str) -> int:
    """Bytes/element for a dtype string; substrings accepted ("int8" in
    "lstm-int8"). Unknown dtypes conservatively cost f32."""
    if dtype in DTYPE_BYTES:
        return DTYPE_BYTES[dtype]
    for name, nbytes in DTYPE_BYTES.items():
        if name in dtype:
            return nbytes
    return F32


def chip_for_dtype(chip: H100Chip, dtype: str) -> H100Chip:
    """Chip whose ``peak_flops`` is the rate that runs ``dtype``'s products:
    int8 on the tensor cores at 1979 TOP/s, bf16 and fp16 there at 989
    TFLOP/s, and anything else (f32 above all) on the CUDA cores at 67."""
    if "int8" in dtype:
        return dataclasses.replace(chip, peak_flops=chip.peak_int8_ops)
    if "bfloat16" in dtype or "float16" in dtype:
        return chip
    return dataclasses.replace(chip, peak_flops=chip.peak_f32_flops)


def arithmetic_intensity(flops: float, hbm_bytes: float) -> float:
    """Ops per device-memory byte — the roofline x-axis."""
    return flops / hbm_bytes if hbm_bytes else float("inf")


def ridge_intensity(chip: H100Chip = DEFAULT_CHIP, *, dtype: str = "bfloat16") -> float:
    """Intensity at which compute and memory terms tie (ops/byte)."""
    return chip_for_dtype(chip, dtype).peak_flops / chip.hbm_bw


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Three-term roofline for one execution.  ``chip.peak_flops`` is the
    rate the work is scored against: pass ``chip_for_dtype(chip, dtype)``."""

    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    chips: int
    model_flops: float  # useful FLOPs, GLOBAL
    chip: H100Chip = DEFAULT_CHIP

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / self.chip.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_dev / self.chip.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_dev / self.chip.link_bw

    @property
    def t_step_s(self) -> float:
        """Perfect-overlap bound: slowest resource wins."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def t_step_noverlap_s(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """Useful FLOPs over executed FLOPs."""
        total = self.flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the perfect-overlap step time."""
        if self.t_step_s <= 0:
            return 0.0
        return self.model_flops / (self.t_step_s * self.chips * self.chip.peak_flops)

    @property
    def roofline_fraction(self) -> float:
        return self.mfu

    def energy_j(self) -> float:
        util = self.compute_s / self.t_step_s if self.t_step_s else 0.0
        return self.t_step_s * self.chips * self.chip.step_power(util)

    def flops_per_joule(self) -> float:
        e = self.energy_j()
        return self.model_flops / e if e else 0.0

    def summary(self) -> dict[str, Any]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "t_step_s": self.t_step_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "mfu": self.mfu,
            "energy_j": self.energy_j(),
            "gflops_per_j": self.flops_per_joule() / 1e9,
        }
