"""Deterministic, seeded fault injection for the serving tick loop.

Overload and faults are routine at pervasive-deployment scale, not
exceptional, so the serving scheduler must be exercisable under them
REPRODUCIBLY: every fault decision here comes from one seeded generator
whose draws are consumed in the scheduler's (deterministic) tick order, so
a scenario is fully described by its :class:`FaultProfile` — rerunning the
same stream with the same profile injects the identical fault sequence.

Five fault classes, mirroring what real accelerator fleets see:

  NaN poisoning     a slot's device cache rows are overwritten with NaN
                    mid-decode (HBM corruption, a bad reduction, an overflow
                    in a fused kernel). The engine's tick-level finiteness guard
                    flags the slot the same tick; the scheduler quarantines
                    it and re-prefills the request from its last committed
                    tokens under a bounded-backoff retry budget
                    (``core.retry.RestartPolicy``).
  stall ticks       a busy tick takes ``stall_factor``× its calibrated time
                    (straggling host, preempted VM, thermal throttle). Fed
                    to the shared ``StragglerDetector``; counted in the
                    report.
  chunk faults      one chunked-prefill step's work is lost (the group's
                    cache does not advance). The scheduler retries the chunk
                    next tick; past the retry budget the group degrades to
                    BLOCKING admission and chunking is disabled for the rest
                    of the run.
  page pressure     a transient shrink of the paged pool's usable budget:
                    ``press_pages`` free pages are pinned out for one
                    decode/verify tick (a co-tenant grabbing HBM, memory
                    ballooning, fragmentation). Drives the scheduler's
                    watermark into preempting slots — mid-decode exhaustion
                    becomes deterministic and testable instead of a crash.
  thermal throttle  the clock drops to fraction ``therm_frac`` at a busy
                    tick and recovers linearly over ``therm_ticks``
                    calibrated steps (``serving/power.py`` models the
                    DVFS time-stretch and dynamic-power scaling). Feeds
                    the brownout governor's degradation ladder.

In the reference, profiles are wired through ``ServeConfig.faults`` (or
passed to the scheduler directly), so an engine + config pair pins the
whole scenario.  The port's engine refuses ``ServeConfig.faults`` until the
scheduler that reads it is ported; the profiles and the injector are here.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """One reproducible fault scenario (all rates are per-opportunity
    Bernoulli probabilities drawn from the seeded generator)."""

    seed: int = 0
    nan_rate: float = 0.0         # per decoding slot per decode/verify tick
    stall_rate: float = 0.0       # per busy tick (decode/verify/chunk)
    stall_factor: float = 8.0     # stalled tick duration multiplier
    chunk_fault_rate: float = 0.0  # per chunked-prefill tick
    press_rate: float = 0.0       # per decode/verify tick on a paged pool
    press_pages: int = 2          # free pages pinned out per pressure event
    therm_rate: float = 0.0       # per busy tick: thermal-throttle onset
    therm_frac: float = 0.5       # clock fraction at the throttle onset
    therm_ticks: int = 16         # recovery back to full clock, in cal steps
    max_faults: int | None = None  # cap on total injected events (None = ∞)

    @property
    def enabled(self) -> bool:
        return (self.nan_rate > 0 or self.stall_rate > 0
                or self.chunk_fault_rate > 0 or self.press_rate > 0
                or self.therm_rate > 0)


# named scenarios for the launcher / benchmarks; ``seed`` is overridden by
# the caller so one name covers a family of reproducible runs
FAULT_PROFILES: dict[str, FaultProfile] = {
    "none": FaultProfile(),
    "light": FaultProfile(nan_rate=0.01, stall_rate=0.02, stall_factor=4.0,
                          chunk_fault_rate=0.02),
    "heavy": FaultProfile(nan_rate=0.08, stall_rate=0.08, stall_factor=8.0,
                          chunk_fault_rate=0.25),
}


def make_profile(spec: str, *, seed: int = 0) -> FaultProfile | None:
    """Resolve a CLI spec: a profile name (``none``/``light``/``heavy``) or
    ``key=value`` pairs (``nan=0.05,stall=0.1,stallx=8,chunk=0.2``)."""
    if spec in FAULT_PROFILES:
        prof = FAULT_PROFILES[spec]
        if not prof.enabled:
            return None
        return dataclasses.replace(prof, seed=seed)
    keys = {"nan": "nan_rate", "stall": "stall_rate", "stallx": "stall_factor",
            "chunk": "chunk_fault_rate", "press": "press_rate",
            "pressn": "press_pages", "therm": "therm_rate",
            "thermf": "therm_frac", "thermt": "therm_ticks",
            "max": "max_faults"}
    kw: dict = {"seed": seed}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        if k not in keys or not v:
            raise ValueError(
                f"bad fault spec {spec!r}: want a profile name "
                f"({sorted(FAULT_PROFILES)}) or comma-joined {sorted(keys)}=float")
        kw[keys[k]] = int(v) if k in ("max", "pressn", "thermt") else float(v)
    prof = FaultProfile(**kw)
    return prof if prof.enabled else None


class FaultInjector:
    """Seeded draw-by-draw injector; one instance per scheduler run.

    Draws are consumed in the scheduler's tick order, which is itself
    deterministic given the request stream, so the injected fault sequence
    is a pure function of (profile, stream)."""

    def __init__(self, profile: FaultProfile):
        self.profile = profile
        self.rng = np.random.default_rng(profile.seed)
        self.events = 0

    def _budget_left(self) -> bool:
        return (self.profile.max_faults is None
                or self.events < self.profile.max_faults)

    def poison_victims(self, slots: list[int]) -> list[int]:
        """Which of this tick's decoding slots get their cache poisoned."""
        p = self.profile.nan_rate
        if p <= 0 or not slots:
            return []
        draws = self.rng.random(len(slots))
        victims = []
        for s, d in zip(slots, draws):
            if d < p and self._budget_left():
                victims.append(s)
                self.events += 1
        return victims

    def stall(self) -> float:
        """Duration multiplier for the current busy tick (1.0 = healthy)."""
        if self.profile.stall_rate <= 0:
            return 1.0
        if self.rng.random() < self.profile.stall_rate and self._budget_left():
            self.events += 1
            return self.profile.stall_factor
        return 1.0

    def press(self) -> int:
        """Pages to pin out of the paged pool for this decode/verify tick
        (0 = no pressure event). Draws only when the axis is enabled, so
        profiles without it keep their exact historical draw sequences."""
        if self.profile.press_rate <= 0:
            return 0
        if self.rng.random() < self.profile.press_rate and self._budget_left():
            self.events += 1
            return self.profile.press_pages
        return 0

    def thermal(self) -> float | None:
        """Clock fraction of a thermal-throttle event starting this busy
        tick (``None`` = no event). Draws only when the axis is enabled, so
        profiles without it keep their exact historical draw sequences."""
        if self.profile.therm_rate <= 0:
            return None
        if self.rng.random() < self.profile.therm_rate and self._budget_left():
            self.events += 1
            return self.profile.therm_frac
        return None

    def chunk_fails(self) -> bool:
        """Whether the current chunked-prefill step's work is lost."""
        if self.profile.chunk_fault_rate <= 0:
            return False
        if self.rng.random() < self.profile.chunk_fault_rate and self._budget_left():
            self.events += 1
            return True
        return False
