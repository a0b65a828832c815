"""Hysteretic brownout governor: a degradation ladder for power deficits.

When the live power cap (thermal event, capped rail, energy budget —
``serving/power.py``) drops below what the pool wants to draw, the
scheduler has a choice of *what to give up first*. The governor encodes
that choice as a ladder, walked one level at a time:

    | level | name       | action                                          |
    |-------|------------|-------------------------------------------------|
    | 0     | nominal    | nothing                                         |
    | 1     | spec_half  | batch-tier speculative windows capped at k//2   |
    |       |            | (``SpecThrottle.halved`` — same walk, same      |
    |       |            | verify graphs as acceptance throttling)         |
    | 2     | spec_off   | batch-tier speculation disabled                 |
    | 3     | blocking   | chunked admission falls back to blocking        |
    | 4     | slow_down  | duty-cycle idle inserted before busy ticks      |
    |       |            | (the paper's Slow-Down, now load-bearing)       |
    | 5     | preempt    | one batch-tier slot preempted per escalation    |
    |       |            | (the scheduler's preemption policy picks it)    |
    | 6     | shed       | new batch-tier arrivals shed at ingest          |

Latency-tier work is the last thing touched: levels 1–2 degrade only
batch-tier speculation (the scheduler exempts latency-tier windows),
levels 3–4 trade pool throughput for watts, and levels 5–6 sacrifice
batch-tier work outright so the latency tier keeps its deadlines — the
"prefer degradation over latency-tier deadline misses" contract of the
energy-budget enforcement.

Hysteresis: the controller escalates when its rolling power estimate
exceeds ``hi``·cap and de-escalates below ``lo``·cap, with ``lo < hi``
(asymmetric thresholds) AND a minimum dwell of ``dwell_ticks`` updates at
a level before the next move — so the ladder cannot flap, and moves are
always ±1 (never skips a level).

Every action the ladder takes reuses a mechanism whose token-for-token
exactness the reference's tests prove (window shrink, blocking admission,
idle insertion, preempt-and-restore, shedding), so a brownout changes
*scheduling only*: completed requests are token-identical to the
unconstrained run.

:class:`UniformThrottle` is the naive baseline the benchmark compares
against: no ladder, no tiers — every busy tick is stretched with idle
until its own average draw meets the cap.
"""
from __future__ import annotations

import math

from .draft import SpecThrottle
from .power import RollingLedger

LEVELS = ("nominal", "spec_half", "spec_off", "blocking",
          "slow_down", "preempt", "shed")


class BrownoutController:
    """The hysteretic ladder (see module docstring)."""

    name = "ladder"

    def __init__(self, *, window_s: float = 0.25, hi: float = 0.92,
                 lo: float = 0.70, dwell_ticks: int = 6):
        if not 0.0 < lo < hi:
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if dwell_ticks < 1:
            raise ValueError("dwell_ticks must be >= 1")
        self.window_s = float(window_s)
        self.hi = float(hi)
        self.lo = float(lo)
        self.dwell_ticks = int(dwell_ticks)
        self.level = 0
        self.dwell = [0] * len(LEVELS)   # updates observed at each level
        self.transitions = 0
        self.brownout_ticks = 0          # updates at any level > 0
        self._ticks_here = 0
        self._preempt_credit = 0
        self._ledger = RollingLedger(self.window_s)

    # ---- observation -----------------------------------------------------
    def observe(self, t0: float, t1: float, joules: float) -> None:
        """Feed one ledger span (busy, idle, or gap) into the estimate."""
        if t1 > t0:
            self._ledger.add(t0, t1, joules / (t1 - t0))

    def power_w(self, t: float) -> float:
        """Rolling mean draw over the governor window ending at ``t``."""
        return self._ledger.mean_w(t)

    def update(self, t: float, cap_w: float) -> int:
        """One control update against the live cap; returns -1/0/+1."""
        self.dwell[self.level] += 1
        if self.level > 0:
            self.brownout_ticks += 1
        self._ticks_here += 1
        if self._ticks_here < self.dwell_ticks:
            return 0
        est = self.power_w(t)
        if math.isfinite(cap_w) and est > self.hi * cap_w \
                and self.level < len(LEVELS) - 1:
            self.level += 1
            if self.level >= LEVELS.index("preempt"):
                self._preempt_credit += 1
            self.transitions += 1
            self._ticks_here = 0
            return 1
        if self.level > 0 and (not math.isfinite(cap_w)
                               or est < self.lo * cap_w):
            self.level -= 1
            self.transitions += 1
            self._ticks_here = 0
            return -1
        return 0

    # ---- ladder knobs the scheduler reads --------------------------------
    def spec_cap(self, k: int) -> int:
        """Speculative-window cap at the current level."""
        if self.level >= LEVELS.index("spec_off"):
            return 0
        if self.level >= LEVELS.index("spec_half"):
            return max(SpecThrottle.halved(k, 1), 1)
        return k

    def chunk_ok(self) -> bool:
        """Whether chunked admission is still allowed."""
        return self.level < LEVELS.index("blocking")

    def pace_idle(self, dur: float, busy_w: float, cap_w: float) -> float:
        """Slow-Down pacing: idle seconds to insert before a busy tick so
        tick + idle average at the cap. Active from the slow_down level."""
        if (self.level >= LEVELS.index("slow_down")
                and math.isfinite(cap_w) and busy_w > cap_w > 0):
            return dur * (busy_w / cap_w - 1.0)
        return 0.0

    def defer_batch(self) -> bool:
        """Hold batch-tier (re-)admission while in the preempt band, so a
        preemption actually SHRINKS the pool for as long as the deficit
        lasts — without this, swapped-out victims re-admit on the next
        tick and the preemption is churn (two transfers, zero sustained
        watts shed)."""
        return self.level >= LEVELS.index("preempt")

    def take_preempt(self) -> bool:
        """One batch-tier preemption per escalation into preempt+; consumed
        by the scheduler at the next tick boundary (never mid-tick)."""
        if self.level >= LEVELS.index("preempt") and self._preempt_credit > 0:
            self._preempt_credit -= 1
            return True
        return False

    def shed_batch(self) -> bool:
        """Shed NEW batch-tier arrivals (retries are never blocked)."""
        return self.level >= LEVELS.index("shed")


class UniformThrottle(BrownoutController):
    """Ladder-less baseline: pace EVERY busy tick to the cap, touch nothing
    else. Latency and batch tiers are slowed identically — which is exactly
    the behaviour the brownout benchmark shows losing the latency-tier SLO."""

    name = "uniform"

    def update(self, t: float, cap_w: float) -> int:
        self.dwell[self.level] += 1
        self._ticks_here += 1
        return 0

    def pace_idle(self, dur: float, busy_w: float, cap_w: float) -> float:
        if math.isfinite(cap_w) and busy_w > cap_w > 0:
            self.brownout_ticks += 1
            return dur * (busy_w / cap_w - 1.0)
        return 0.0


GOVERNORS = ("ladder", "uniform")


def make_governor(spec) -> BrownoutController | None:
    """``None``/``"off"`` → no governor; ``"ladder"``/``"uniform"`` → a fresh
    controller; an instance passes through (caller owns its lifecycle)."""
    if spec is None or spec == "off":
        return None
    if isinstance(spec, BrownoutController):
        return spec
    if spec == "ladder":
        return BrownoutController()
    if spec == "uniform":
        return UniformThrottle()
    raise ValueError(f"unknown brownout governor {spec!r}: "
                     f"want one of {GOVERNORS} or a BrownoutController")
