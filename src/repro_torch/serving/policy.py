"""Online duty-cycle policies — the paper's RQ2 strategies recast as LIVE
decisions between queue drains.

``core/workload.py`` scores the same strategies *offline*: it gets the whole
gap trace up front and charges each gap's energy in one vectorized pass. A
serving scheduler does not have that luxury — when the slot pool drains it
must decide sleep / stay-configured / stretch *now*, knowing only the gaps
it has already observed. Each policy here therefore exposes

    on_gap(gap_s) -> GapOutcome(energy_j, wake_s, slept)

where the DECISION may only use past observations (the gap length itself is
revealed to the estimator only after the decision is charged — exactly the
information structure of the ski-rental problem the adaptive threshold
solves).

Mapping to the paper's strategy taxonomy (§3.2):

  on_off        OnOffPolicy       — power off immediately, pay E_cfg + t_cfg
                                    on the next arrival
  idle_waiting  IdleWaitingPolicy — stay configured at P_idle for the gap
  slow_down     SlowDownPolicy    — stretch the next inference across the
                                    gap at the static-power floor
  adaptive(τ)   StreamingTauPolicy— idle up to τ then power off; τ starts at
                                    the break-even threshold and is refit
                                    online: an exponentially-weighted window
                                    of observed gaps is handed to
                                    ``learn_tau`` every ``refit_every``
                                    observations (the learnable threshold of
                                    C4, made streaming)
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.core.workload import AccelProfile, break_even_tau, learn_tau
from repro_torch.kernels.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class GapOutcome:
    """What one idle gap cost: energy, extra wake latency charged to the
    NEXT request (reconfiguration), and whether the device powered off."""

    energy_j: float
    wake_s: float
    slept: bool


class DutyCyclePolicy:
    """Base: holds the accelerator profile the costs are charged against."""

    name = "base"

    def __init__(self, profile: AccelProfile):
        self.p = profile
        # busy-time ledger by tick kind ("prefill" / "decode") — with chunked
        # prefill the scheduler's ticks are MIXED, and a policy deciding what
        # to do with the next gap gets to see how the busy time it just
        # observed was composed
        self.busy_s: dict[str, float] = {}

    def on_busy(self, kind: str, duration_s: float) -> None:
        """Observation hook: the scheduler reports every busy tick (chunked
        prefill advance, masked decode step) before the next gap decision."""
        self.busy_s[kind] = self.busy_s.get(kind, 0.0) + float(duration_s)

    def on_throttle(self, idle_s: float) -> None:
        """Brownout/cap-enforcement idle inserted INSIDE the busy stream —
        the paper's Slow-Down imposed by the power governor rather than
        chosen at a gap. Logged under its own kind so a gap decision can
        see how much recent "busy" time was throttle stretch, not compute."""
        self.on_busy("slow_down", idle_s)

    def on_gap(self, gap_s: float) -> GapOutcome:
        raise NotImplementedError

    @property
    def tau(self) -> float | None:
        return None


class OnOffPolicy(DutyCyclePolicy):
    name = "on_off"

    def on_gap(self, gap_s: float) -> GapOutcome:
        return GapOutcome(self.p.e_cfg_j, self.p.t_cfg_s, True)


class IdleWaitingPolicy(DutyCyclePolicy):
    name = "idle_waiting"

    def on_gap(self, gap_s: float) -> GapOutcome:
        return GapOutcome(self.p.p_idle_w * gap_s, 0.0, False)


class SlowDownPolicy(DutyCyclePolicy):
    name = "slow_down"

    def on_gap(self, gap_s: float) -> GapOutcome:
        return GapOutcome(self.p.static_w * gap_s, 0.0, False)


class StreamingTauPolicy(DutyCyclePolicy):
    """Ski-rental with an ONLINE learned threshold.

    Idle at P_idle up to τ into the gap, then power off (pay E_cfg and t_cfg
    at wake). τ starts at the predefined break-even E_cfg/P_idle and is
    periodically refit by gradient training (``learn_tau``) on the recent
    gap window with exponential recency weights, so a regime change in the
    arrival process moves τ within one window.  The refits run on
    ``device`` (``None`` means the card, as ``learn_tau``'s; pass ``"cpu"``
    to refit on the host), resolved here, so that a policy asked for a card
    that is not there raises at construction.
    """

    name = "adaptive"

    def __init__(self, profile: AccelProfile, *, window: int = 512,
                 refit_every: int = 64, refit_steps: int = 200,
                 decay: float = 0.995, lr: float = 0.05, device=None):
        super().__init__(profile)
        self.device = resolve_device(device)
        self._tau = break_even_tau(profile)
        self.window = collections.deque(maxlen=window)
        self.refit_every = refit_every
        self.refit_steps = refit_steps
        self.decay = decay
        self.lr = lr
        self.seen = 0
        self.refits = 0

    @property
    def tau(self) -> float:
        return self._tau

    def on_gap(self, gap_s: float) -> GapOutcome:
        # decide with the CURRENT τ (past information only) ...
        if gap_s <= self._tau:
            out = GapOutcome(self.p.p_idle_w * gap_s, 0.0, False)
        else:
            out = GapOutcome(self.p.p_idle_w * self._tau + self.p.e_cfg_j,
                             self.p.t_cfg_s, True)
        # ... then fold the revealed gap into the estimator
        self.observe(gap_s)
        return out

    def observe(self, gap_s: float) -> None:
        self.window.append(float(gap_s))
        self.seen += 1
        if self.seen % self.refit_every == 0:
            gaps = np.asarray(self.window, float)
            ages = np.arange(len(gaps) - 1, -1, -1, dtype=float)
            self._tau = learn_tau(
                gaps, self.p, steps=self.refit_steps, lr=self.lr,
                tau0=self._tau, weights=self.decay ** ages, device=self.device,
            )
            self.refits += 1


POLICIES = {
    p.name: p
    for p in (OnOffPolicy, IdleWaitingPolicy, SlowDownPolicy, StreamingTauPolicy)
}


def make_policy(name: str, profile: AccelProfile, *, device=None,
                **kw) -> DutyCyclePolicy:
    """A fresh policy by name; ``device`` goes to the one that refits on a
    device (``adaptive``, ``None`` meaning the card) and is not read by the
    others, whose charges are host arithmetic."""
    if name not in POLICIES:
        raise ValueError(f"unknown policy {name!r}; known: {sorted(POLICIES)}")
    if POLICIES[name] is StreamingTauPolicy:
        kw["device"] = device
    return POLICIES[name](profile, **kw)
