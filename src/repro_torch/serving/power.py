"""Time-varying power envelopes for the serving scheduler.

The paper's whole premise is operating under a *power constraint*; this
module makes that constraint a first-class, time-varying input to the
serving tick loop instead of a fixed ``H100Chip`` constant. Three pieces:

:class:`ThermalEvent`
    A throttle onset: at ``start_s`` the clock drops to fraction ``frac``
    and recovers linearly to full clock over ``recover_s`` (``inf`` =
    permanent derate). Deterministic, so the virtual clock stays a pure
    function of the stream + profile.

:class:`CapWindow`
    A sustained power-cap interval: between ``start_s`` and ``end_s`` the
    rolling-window average draw must stay under ``cap_w`` watts (total,
    across all chips).

:class:`PowerEnvelope`
    The composed signal — scripted events/caps plus *dynamic* thermal
    events appended mid-run by the seeded fault axis
    (``FaultProfile.therm_rate``). ``clock_frac(t)`` is the min over
    active events; ``cap_w(t)`` the min over active cap windows.
    ``reset()`` clears only the dynamic events, so one envelope instance
    can be replayed across scheduler arms.

:class:`RollingLedger`
    The compliance bookkeeping: a sliding window of ``(t0, t1, watts)``
    segments. Enforcement uses a *conservative idle-floor* accounting —
    window energy is evaluated as ``floor_w * window + Σ max(w - floor_w,
    0) * overlap`` — i.e. all unrecorded / idle / off time is assumed to
    draw ``floor_w`` (the idle power). Under that bound, inserted idle
    contributes zero excess and windowed excess peaks exactly at busy
    segment ends, so checking (and enforcing) at each busy tick's end
    guarantees NO window anywhere in continuous time exceeds the cap.
    ``idle_needed`` solves the minimal pre-tick idle that lets the next
    busy tick fit; the excess is piecewise linear in the inserted idle so
    the exact crossing comes from a breakpoint walk, no search loop.

DVFS semantics (mirrored by ``H100Chip.dvfs_power``): at clock fraction
``f`` a calibrated tick stretches to ``base / f`` seconds and draws
``p_idle + (p_peak - p_idle) * util * f`` watts — the dynamic term scales
with frequency, the static term does not, so throttling trades dynamic
energy for static energy exactly the way the paper's Slow-Down analysis
trades it (§3.2).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np

from repro_torch.core.energy import DEFAULT_CHIP

#: clock fractions are clamped here — a thermal event cannot stop the clock
#: outright (the virtual run must always make progress)
MIN_CLOCK_FRAC = 0.05


@dataclasses.dataclass(frozen=True)
class ThermalEvent:
    """One thermal-throttle onset with a linear recovery ramp."""

    start_s: float
    frac: float          # clock fraction at onset, in (0, 1]
    recover_s: float     # seconds back to full clock (inf = permanent)

    def clock_frac(self, t: float) -> float:
        dt = t - self.start_s
        if dt < 0 or dt >= self.recover_s:
            return 1.0
        return self.frac + (1.0 - self.frac) * (dt / self.recover_s)


@dataclasses.dataclass(frozen=True)
class CapWindow:
    """A sustained power-cap interval (total watts across all chips)."""

    start_s: float
    end_s: float
    cap_w: float

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.end_s


class PowerEnvelope:
    """Composed clock/cap signal: scripted events + fault-driven throttles.

    ``window_s`` is the compliance window for cap enforcement: the
    scheduler's rolling ledger guarantees the windowed average draw never
    exceeds the live ``cap_w(t)``.
    """

    def __init__(self, events: tuple[ThermalEvent, ...] = (),
                 caps: tuple[CapWindow, ...] = (), *,
                 window_s: float = 0.25):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        for c in caps:
            if c.cap_w <= 0 or c.end_s <= c.start_s:
                raise ValueError(f"bad cap window {c}")
        self.scripted = tuple(events)
        self.caps = tuple(caps)
        self.window_s = float(window_s)
        self._dynamic: list[ThermalEvent] = []

    def reset(self) -> None:
        """Drop fault-driven events; scripted ones survive (so one envelope
        replays identically across scheduler arms)."""
        self._dynamic.clear()

    def throttle(self, t: float, frac: float, recover_s: float) -> None:
        """Append a dynamic thermal event (the seeded ``therm=`` fault axis)."""
        frac = min(max(frac, MIN_CLOCK_FRAC), 1.0)
        self._dynamic.append(ThermalEvent(t, frac, max(recover_s, 0.0)))

    def clock_frac(self, t: float) -> float:
        f = 1.0
        for ev in self.scripted:
            f = min(f, ev.clock_frac(t))
        for ev in self._dynamic:
            f = min(f, ev.clock_frac(t))
        return max(f, MIN_CLOCK_FRAC)

    def cap_w(self, t: float) -> float:
        cap = math.inf
        for c in self.caps:
            if c.active(t):
                cap = min(cap, c.cap_w)
        return cap

    @property
    def has_caps(self) -> bool:
        return bool(self.caps)

    @classmethod
    def seeded(cls, seed: int, horizon_s: float, *,
               peak_w: float | None = None,
               n_therm: int = 3,
               therm_frac: tuple[float, float] = (0.4, 0.75),
               therm_recover: tuple[float, float] = (0.05, 0.2),
               cap_frac: tuple[float, float] = (0.6, 0.75),
               cap_cover: tuple[float, float] = (0.05, 0.95),
               window_s: float = 0.25) -> "PowerEnvelope":
        """Deterministic scenario generator: one sustained cap window over
        ``cap_cover`` of the horizon at a cap drawn from ``cap_frac`` of
        ``peak_w``, plus ``n_therm`` thermal dips. Same seed → same
        envelope, so benchmark arms share the exact constraint.  The default
        ``peak_w`` is ``H100Chip.p_peak_w``, the card's 700 W power limit
        (the reference's default chip is its TPU)."""
        chip = DEFAULT_CHIP
        peak = float(peak_w if peak_w is not None else chip.p_peak_w)
        rng = np.random.default_rng(seed)
        caps = (CapWindow(cap_cover[0] * horizon_s, cap_cover[1] * horizon_s,
                          float(rng.uniform(*cap_frac)) * peak),)
        events = tuple(
            ThermalEvent(float(rng.uniform(0.0, horizon_s)),
                         float(rng.uniform(*therm_frac)),
                         float(rng.uniform(*therm_recover)) * horizon_s)
            for _ in range(n_therm))
        return cls(events, caps, window_s=window_s)


class RollingLedger:
    """Sliding-window energy ledger over ``(t0, t1, watts)`` segments.

    ``floor_w`` is the conservative idle-floor power: compliance treats
    every instant not covered by a recorded segment — and every recorded
    watt below the floor — as drawing exactly ``floor_w``. See the module
    docstring for why that makes busy-tick-end enforcement a continuous-
    time guarantee."""

    def __init__(self, window_s: float, *, cap_w: float = math.inf,
                 floor_w: float = 0.0):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.window_s = float(window_s)
        self.cap_w = float(cap_w)
        self.floor_w = float(floor_w)
        self.segs: deque[tuple[float, float, float]] = deque()
        self.peak_window_j = 0.0   # conservative window energy, max over adds
        self.peak_window_w = 0.0

    def add(self, t0: float, t1: float, watts: float) -> None:
        """Record a segment and update the peak-window stats at its end."""
        if t1 <= t0:
            return
        self.segs.append((t0, t1, watts))
        while self.segs and self.segs[0][1] <= t1 - self.window_s:
            self.segs.popleft()
        e = self.window_j(t1)
        if e > self.peak_window_j:
            self.peak_window_j = e
            self.peak_window_w = e / self.window_s

    def _excess_j(self, t_end: float) -> float:
        lo = t_end - self.window_s
        e = 0.0
        for a, b, w in self.segs:
            if w > self.floor_w:
                e += (w - self.floor_w) * max(0.0, min(b, t_end) - max(a, lo))
        return e

    def window_j(self, t_end: float) -> float:
        """Conservative energy of the window ending at ``t_end``."""
        return self.floor_w * self.window_s + self._excess_j(t_end)

    def window_w(self, t_end: float) -> float:
        return self.window_j(t_end) / self.window_s

    def mean_w(self, t_end: float) -> float:
        """Plain (non-conservative) windowed mean power — the brownout
        governor's load estimate: recorded joules over the window span."""
        lo = t_end - self.window_s
        e = 0.0
        for a, b, w in self.segs:
            e += w * max(0.0, min(b, t_end) - max(a, lo))
        return e / self.window_s

    def violates(self, t_end: float, cap_w: float | None = None) -> bool:
        cap = self.cap_w if cap_w is None else cap_w
        if not math.isfinite(cap):
            return False
        return self.window_j(t_end) > cap * self.window_s * (1.0 + 1e-9)

    def idle_needed(self, t: float, dur: float, busy_w: float,
                    cap_w: float | None = None) -> float:
        """Minimal idle seconds to insert at ``t`` so a busy tick of
        ``dur`` seconds at ``busy_w`` watts ends with its window under the
        cap. Inserted idle has zero excess under the floor accounting, so
        waiting only rolls old busy segments out of the window; the excess
        is piecewise linear in the wait with breakpoints where the window's
        trailing edge crosses a segment boundary."""
        cap = self.cap_w if cap_w is None else cap_w
        if not math.isfinite(cap) or dur <= 0:
            return 0.0
        budget = (cap - self.floor_w) * self.window_s
        tick = (busy_w - self.floor_w) * min(dur, self.window_s)

        def excess(s: float) -> float:
            return tick + self._excess_j(t + s + dur) - budget

        e_prev, prev = excess(0.0), 0.0
        if e_prev <= 1e-12 * max(abs(budget), 1.0):
            return 0.0
        # shift s at which the trailing edge (t + s + dur - W) crosses each
        # recorded segment edge; beyond the last one the excess is constant
        edges = sorted({max(0.0, edge + self.window_s - dur - t)
                        for a, b, _ in self.segs for edge in (a, b)})
        for s in edges:
            if s <= prev:
                continue
            e_s = excess(s)
            if e_s <= 0.0:
                return prev + (s - prev) * e_prev / max(e_prev - e_s, 1e-30)
            prev, e_prev = s, e_s
        # infeasible even with every old segment purged (cap below the tick
        # itself): wait the full purge; the violation is counted by the
        # caller's ``violates`` check
        return prev
