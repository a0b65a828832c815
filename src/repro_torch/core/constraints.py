"""Application-specific knowledge (RQ3): goals + constraints + workload.

The paper's third Generator input. An ``ApplicationSpec`` bundles

  * the optimization goal (one prioritized metric, §2.2),
  * hard constraints (latency threshold, resource budget, precision bound,
    deadline-miss tolerance) used for early analytical pruning,
  * the application's workload description (request-gap trace) that the
    workload-aware strategies (RQ2) are scored against.

``check(point, estimate)`` returns (feasible, reason) so the Generator can
report *why* candidates were pruned — the paper's "early pruning of
suboptimal designs" made inspectable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.candidates import DesignPoint, Estimate

GOALS = (
    "energy_efficiency",   # maximize items per joule over the workload
    "gops_per_w",          # maximize raw compute efficiency (paper C2 metric)
    "latency",             # minimize single-inference latency (paper C1 metric)
    "throughput",          # maximize items/s (ignoring energy)
)


@dataclasses.dataclass(frozen=True)
class ApplicationSpec:
    """Application-specific knowledge for one deployment scenario."""

    name: str = "default"
    goal: str = "energy_efficiency"
    # -- hard constraints (None = unconstrained) ----------------------------
    max_latency_s: float | None = None
    resource_budget: Mapping[str, float] | None = None  # e.g. {"lut": 8000} or {"hbm_bytes": 80e9}
    max_act_error: float | None = None                  # precision bound (QAT apps tolerate "hard")
    max_deadline_miss_frac: float = 0.0
    # -- workload (request gaps in seconds, after each inference) -----------
    gaps: Any = None  # np.ndarray | None
    period_s: float | None = None  # regular workloads: fixed request period

    def __post_init__(self):
        if self.goal not in GOALS:
            raise ValueError(f"unknown goal {self.goal!r}; known: {GOALS}")

    def trace(self, t_inf_s: float, n: int = 1000) -> np.ndarray:
        """Gap trace for scoring: explicit trace wins, else regular period."""
        if self.gaps is not None:
            return np.asarray(self.gaps, dtype=float)
        if self.period_s is not None:
            return np.full(n, max(self.period_s - t_inf_s, 0.0))
        return np.zeros(0)  # continuous operation: no idle gaps

    # ------------------------------------------------------------------
    def check(self, point: DesignPoint, est: Estimate) -> tuple[bool, str]:
        """Analytical feasibility — the Generator's pruning predicate."""
        if self.max_latency_s is not None and est.latency_s > self.max_latency_s:
            return False, f"latency {est.latency_s:.3e}s > {self.max_latency_s:.3e}s"
        if self.max_act_error is not None and est.max_act_error > self.max_act_error:
            return False, f"act error {est.max_act_error:.2e} > {self.max_act_error:.2e}"
        if self.resource_budget:
            for res, budget in self.resource_budget.items():
                used = est.resources.get(res)
                if used is not None and used > budget:
                    return False, f"{res} {used:.4g} > budget {budget:.4g}"
        return True, ""


# ---------------------------------------------------------------------------
# Scenario library — the "diverse application scenarios" of the abstract.
# Used by examples/ and benchmarks/generator_*.py.
# ---------------------------------------------------------------------------
def scenario_regular_sensor(period_s: float = 0.040) -> ApplicationSpec:
    """Paper §3.2 regime: a sensor fires every ``period_s`` (C3's 40 ms)."""
    return ApplicationSpec(
        name=f"regular-{period_s * 1e3:.0f}ms",
        goal="energy_efficiency",
        max_latency_s=period_s,
        period_s=period_s,
    )


def scenario_irregular(gaps: np.ndarray, max_latency_s: float = 0.05) -> ApplicationSpec:
    """Irregular IoT workload (C4's regime) — trace-driven."""
    return ApplicationSpec(
        name="irregular",
        goal="energy_efficiency",
        max_latency_s=max_latency_s,
        gaps=gaps,
    )


def scenario_latency_critical(deadline_s: float) -> ApplicationSpec:
    """Hard-deadline control loop: minimize latency, precision-bounded."""
    return ApplicationSpec(
        name=f"latency-{deadline_s * 1e6:.0f}us",
        goal="latency",
        max_latency_s=deadline_s,
        max_act_error=5e-3,  # no "hard" variants unless QAT-trained
    )


def scenario_continuous_throughput() -> ApplicationSpec:
    """Always-busy pipeline: classic GOPS/W accelerator benchmark (C2)."""
    return ApplicationSpec(name="continuous", goal="gops_per_w")
