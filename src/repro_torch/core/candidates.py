"""Design-point machinery: the Generator's candidate representation.

A ``DesignPoint`` is an immutable assignment of values to named design axes
(the paper's "accelerator configuration"). A ``DesignSpace`` is the cartesian
product of axis domains; the Generator explores it with exhaustive, beam, or
evolutionary search (core/generator.py).

Both hardware backends expose their axes through this machinery:

  FPGA backend   n_mac × n_act × act_impl × pipelined   (RTL templates, RQ1)
  GPU backend    act_impl × attention_impl × precision × remat × scan
                 (core/cost_model.GPUCostBackend, beyond the paper)

plus the shared workload-strategy axis (RQ2): strategy × threshold-mode.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Any, Iterator, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One candidate configuration: a frozen mapping of axis → value."""

    values: tuple[tuple[str, Any], ...]  # sorted ((axis, value), ...)

    @staticmethod
    def of(**kw: Any) -> "DesignPoint":
        return DesignPoint(tuple(sorted(kw.items())))

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "DesignPoint":
        return DesignPoint(tuple(sorted(d.items())))

    def __getitem__(self, axis: str) -> Any:
        for k, v in self.values:
            if k == axis:
                return v
        raise KeyError(axis)

    def get(self, axis: str, default: Any = None) -> Any:
        for k, v in self.values:
            if k == axis:
                return v
        return default

    def replace(self, **kw: Any) -> "DesignPoint":
        d = dict(self.values)
        d.update(kw)
        return DesignPoint.from_dict(d)

    def as_dict(self) -> dict[str, Any]:
        return dict(self.values)

    def __repr__(self) -> str:  # compact, stable — used in logs/EXPERIMENTS.md
        inner = ", ".join(f"{k}={v}" for k, v in self.values)
        return f"DP({inner})"


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Cartesian product of axis domains, with iteration/sampling/mutation."""

    axes: Mapping[str, tuple[Any, ...]]

    def __post_init__(self):
        for name, dom in self.axes.items():
            if not dom:
                raise ValueError(f"axis {name!r} has an empty domain")

    @property
    def size(self) -> int:
        n = 1
        for dom in self.axes.values():
            n *= len(dom)
        return n

    def __iter__(self) -> Iterator[DesignPoint]:
        names = sorted(self.axes)
        for combo in itertools.product(*(self.axes[n] for n in names)):
            yield DesignPoint(tuple(zip(names, combo)))

    def sample(self, n: int, rng: random.Random) -> list[DesignPoint]:
        names = sorted(self.axes)
        out = []
        for _ in range(n):
            combo = tuple(rng.choice(self.axes[a]) for a in names)
            out.append(DesignPoint(tuple(zip(names, combo))))
        return out

    def mutate(self, p: DesignPoint, rng: random.Random, n_axes: int = 1) -> DesignPoint:
        """Re-draw ``n_axes`` randomly chosen axes (evolutionary search step)."""
        names = rng.sample(sorted(self.axes), k=min(n_axes, len(self.axes)))
        repl = {a: rng.choice(self.axes[a]) for a in names}
        return p.replace(**repl)

    def crossover(self, a: DesignPoint, b: DesignPoint, rng: random.Random) -> DesignPoint:
        """Uniform crossover (evolutionary search step)."""
        d = {}
        for axis in self.axes:
            d[axis] = (a if rng.random() < 0.5 else b).get(axis)
        return DesignPoint.from_dict(d)

    def neighbors(self, p: DesignPoint) -> Iterator[DesignPoint]:
        """All single-axis changes of ``p`` (beam-search moves)."""
        for axis, dom in sorted(self.axes.items()):
            cur = p.get(axis)
            for v in dom:
                if v != cur:
                    yield p.replace(**{axis: v})

    def contains(self, p: DesignPoint) -> bool:
        return all(p.get(a) in dom for a, dom in self.axes.items())


@dataclasses.dataclass(frozen=True)
class Estimate:
    """Analytical performance estimate for one candidate (pre-evaluation).

    The Generator prunes and ranks on these numbers; the evaluation phase
    (dry-run compile / simulation / hardware) then validates the survivors —
    the paper's two-stage explore-then-evaluate flow (§2.2/§2.3).
    """

    latency_s: float            # one inference
    power_active_w: float       # while inferring
    power_idle_w: float         # configured-but-idle
    energy_per_inf_j: float     # latency × active power
    resources: Mapping[str, float]  # backend-specific utilization report
    max_act_error: float = 0.0  # precision cost of the chosen variants
    cfg_energy_j: float = 0.0   # configuration (reload) energy
    cfg_time_s: float = 0.0
    ops: float = 0.0            # useful ops per inference

    @property
    def gops_per_w(self) -> float:
        if self.energy_per_inf_j <= 0:
            return 0.0
        return self.ops / self.energy_per_inf_j / 1e9


def pareto_front(
    points: Sequence[tuple[DesignPoint, Estimate]],
    *,
    keys: Sequence[str] = ("latency_s", "energy_per_inf_j", "max_act_error"),
) -> list[tuple[DesignPoint, Estimate]]:
    """Non-dominated subset under simultaneous minimization of ``keys``."""

    def vec(e: Estimate) -> tuple[float, ...]:
        return tuple(getattr(e, k) for k in keys)

    out: list[tuple[DesignPoint, Estimate]] = []
    for p, e in points:
        v = vec(e)
        dominated = False
        for _, e2 in points:
            w = vec(e2)
            if w != v and all(wi <= vi for wi, vi in zip(w, v)) and any(wi < vi for wi, vi in zip(w, v)):
                dominated = True
                break
        if not dominated:
            out.append((p, e))
    return out
