"""The Generator (paper §2.2 + §4 "future work", built fully here).

Systematically explores {hardware design points × workload strategies} under
application-specific constraints, in three stages mirroring the paper:

  1. Define the design space — a ``CostBackend`` contributes the hardware
     axes (RTL templates on FPGA, kernel/precision/remat variants on TPU);
     the workload-strategy axis (RQ2) is added on top.
  2. Explore & estimate — analytical models (backend.evaluate) score every
     visited point; constraint violations are pruned EARLY with a recorded
     reason. Search methods: exhaustive, beam, evolutionary.
  3. Generate outputs — ranked feasible candidates + the Pareto frontier,
     ready for the systematic-evaluation phase (dry-run compile on TPU,
     cycle/EDA models on FPGA, tests/benchmarks in this repo).

The learnable switching threshold (C4) is expensive (gradient training), so
it refines only the top-``refine_k`` candidates — the paper's progressive
evaluation: cheap analytics first, costly evaluation for survivors.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Protocol, Sequence

import numpy as np

from repro_torch.core.candidates import DesignPoint, DesignSpace, Estimate, pareto_front
from repro_torch.core.constraints import ApplicationSpec
from repro_torch.core.workload import (
    AccelProfile,
    break_even_tau,
    learn_tau,
    simulate,
)

STRATEGIES = ("on_off", "idle_waiting", "slow_down", "adaptive")


class CostBackend(Protocol):
    """What a hardware backend must provide to the Generator."""

    def space(self) -> dict[str, tuple]: ...

    def evaluate(self, point: DesignPoint) -> Estimate: ...

    def feasible(self, point: DesignPoint) -> tuple[bool, str]: ...


# ---------------------------------------------------------------------------
# Candidate scoring = hardware estimate × workload strategy × app goal
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScoredCandidate:
    point: DesignPoint
    strategy: str
    tau: float | None
    estimate: Estimate
    metrics: dict[str, float]
    score: float  # higher is better, in the app's goal metric

    def describe(self) -> str:
        tau = f", tau={self.tau * 1e3:.1f}ms" if self.tau is not None else ""
        return f"{self.point} × {self.strategy}{tau} → {self.score:.4g}"


def profile_of(est: Estimate) -> AccelProfile:
    return AccelProfile(
        t_inf_s=est.latency_s,
        p_active_w=est.power_active_w,
        p_idle_w=est.power_idle_w,
        e_cfg_j=est.cfg_energy_j,
        t_cfg_s=est.cfg_time_s,
    )


def score_candidate(
    point: DesignPoint,
    est: Estimate,
    app: ApplicationSpec,
    *,
    strategies: Sequence[str] = STRATEGIES,
    tau: float | None = None,
) -> ScoredCandidate | None:
    """Best (strategy, score) for one hardware point under the app's goal.

    Returns None when no strategy meets the deadline-miss constraint.
    """
    prof = profile_of(est)
    gaps = app.trace(prof.t_inf_s)

    if app.goal == "latency":
        return ScoredCandidate(
            point, "idle_waiting", None, est,
            {"latency_s": est.latency_s}, -est.latency_s,
        )
    if app.goal == "gops_per_w" or gaps.size == 0:
        return ScoredCandidate(
            point, "idle_waiting", None, est,
            {"gops_per_w": est.gops_per_w}, est.gops_per_w,
        )

    best: ScoredCandidate | None = None
    max_stretch = (
        app.max_latency_s - est.latency_s if app.max_latency_s is not None else None
    )
    for strat in strategies:
        t = (tau if tau is not None else break_even_tau(prof)) if strat == "adaptive" else None
        res = simulate(gaps, strat, prof, tau=t, max_stretch=max_stretch)
        if res.items and res.missed_deadlines / res.items > app.max_deadline_miss_frac:
            continue
        if app.goal == "throughput":
            score = res.items / res.time_s
        else:  # energy_efficiency
            score = res.items_per_joule
        cand = ScoredCandidate(
            point, strat, t, est,
            {
                "items_per_j": res.items_per_joule,
                "energy_j": res.energy_j,
                "missed": float(res.missed_deadlines),
            },
            score,
        )
        if best is None or cand.score > best.score:
            best = cand
    return best


# ---------------------------------------------------------------------------
# Generator result
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class GeneratorResult:
    ranked: list[ScoredCandidate]
    pareto: list[tuple[DesignPoint, Estimate]]
    pruned: list[tuple[DesignPoint, str]]  # (point, reason)
    visited: int
    space_size: int

    @property
    def best(self) -> ScoredCandidate:
        return self.ranked[0]

    def report(self, top: int = 5) -> str:
        lines = [
            f"design space: {self.space_size} points, visited {self.visited}, "
            f"pruned {len(self.pruned)}, feasible {len(self.ranked)}, "
            f"pareto {len(self.pareto)}",
        ]
        for c in self.ranked[:top]:
            lines.append("  " + c.describe())
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# The Generator
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Generator:
    backend: CostBackend
    app: ApplicationSpec
    strategies: Sequence[str] = STRATEGIES
    refine_k: int = 3  # learnable-τ refinement for the top-k (C4 machinery)
    device: Any = None  # where learn_tau trains: None is the card, "cpu" the host

    # -- one-point pipeline: estimate → prune → score -----------------------
    def _consider(
        self, point: DesignPoint, pruned: list[tuple[DesignPoint, str]]
    ) -> ScoredCandidate | None:
        ok, why = self.backend.feasible(point)
        if not ok:
            pruned.append((point, why))
            return None
        est = self.backend.evaluate(point)
        ok, why = self.app.check(point, est)
        if not ok:
            pruned.append((point, why))
            return None
        cand = score_candidate(point, est, self.app, strategies=self.strategies)
        if cand is None:
            pruned.append((point, "deadline-miss constraint"))
        return cand

    # -- search methods ------------------------------------------------------
    def search(
        self,
        method: str = "auto",
        *,
        budget: int = 512,
        beam_width: int = 8,
        generations: int = 12,
        population: int = 32,
        seed: int = 0,
        refine: bool = True,
    ) -> GeneratorResult:
        space = DesignSpace(self.backend.space())
        if method == "auto":
            method = "exhaustive" if space.size <= budget else "evolutionary"

        pruned: list[tuple[DesignPoint, str]] = []
        scored: dict[DesignPoint, ScoredCandidate] = {}
        visited: set[DesignPoint] = set()

        def consider(p: DesignPoint):
            if p in visited:
                return
            visited.add(p)
            c = self._consider(p, pruned)
            if c is not None:
                scored[p] = c

        rng = random.Random(seed)
        if method == "exhaustive":
            for p in space:
                consider(p)
        elif method == "beam":
            frontier = space.sample(beam_width, rng)
            for p in frontier:
                consider(p)
            for _ in range(generations):
                beam = sorted(
                    (c for c in scored.values()), key=lambda c: -c.score
                )[:beam_width]
                if not beam:
                    frontier = space.sample(beam_width, rng)
                    for p in frontier:
                        consider(p)
                    continue
                for c in beam:
                    for nb in space.neighbors(c.point):
                        consider(nb)
        elif method == "evolutionary":
            pop = space.sample(population, rng)
            for p in pop:
                consider(p)
            for _ in range(generations):
                elite = sorted(scored.values(), key=lambda c: -c.score)[: max(population // 4, 2)]
                if not elite:
                    pop = space.sample(population, rng)
                    for p in pop:
                        consider(p)
                    continue
                children = []
                for _ in range(population):
                    a, b = rng.choice(elite), rng.choice(elite)
                    child = space.crossover(a.point, b.point, rng)
                    if rng.random() < 0.5:
                        child = space.mutate(child, rng)
                    children.append(child)
                for p in children:
                    consider(p)
        else:
            raise ValueError(f"unknown search method {method!r}")

        ranked = sorted(scored.values(), key=lambda c: -c.score)

        # -- progressive refinement: learnable τ on the survivors (C4) ------
        if refine and ranked and self.app.goal == "energy_efficiency":
            refined: list[ScoredCandidate] = []
            for c in ranked[: self.refine_k]:
                prof = profile_of(c.estimate)
                gaps = self.app.trace(prof.t_inf_s)
                if gaps.size and "adaptive" in self.strategies:
                    tau = learn_tau(gaps, prof, device=self.device)
                    better = score_candidate(
                        c.point, c.estimate, self.app,
                        strategies=("adaptive",), tau=tau,
                    )
                    if better is not None and better.score > c.score:
                        c = better
                refined.append(c)
            ranked = sorted(refined + ranked[self.refine_k :], key=lambda c: -c.score)

        pareto = pareto_front([(c.point, c.estimate) for c in ranked])
        return GeneratorResult(
            ranked=ranked,
            pareto=pareto,
            pruned=pruned,
            visited=len(visited),
            space_size=space.size,
        )
