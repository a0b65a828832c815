"""Shared fault-handling primitives: straggler detection + bounded-backoff
restart policy.

Consumed by BOTH halves of the system — at 1000+ training nodes, per-step
failures and slow hosts are routine; at serving scale the same is true of
poisoned slots and stalled ticks — so the mechanisms live here, in core,
rather than being duplicated per subsystem:

  * ``StragglerDetector`` — EMA mean/variance of step wall-times with a
    z-score trigger; persistent stragglers (z > threshold for ``patience``
    consecutive steps) raise a mitigation signal. Training responds by
    re-planning (checkpoint → restart); serving counts the signal in its
    ``ServeReport`` (on a real pod the handler evicts/relaunches the host).
  * ``RestartPolicy`` — bounded exponential backoff with a retry budget.
    Training wraps its step loop with ``run_with_restarts`` (restore the
    latest committed checkpoint, replay the deterministic data stream);
    serving budgets quarantine-and-retry re-prefills per request with the
    same ``delay``/``max_restarts`` arithmetic.

Carried over from the reference package's ``core/retry.py`` name for name;
pure Python, so it runs the same on either package's host.  The
reference's training shim (``training/fault.py``) has no counterpart in
the port yet.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable


@dataclasses.dataclass
class StragglerDetector:
    """EMA z-score detector over step times."""

    alpha: float = 0.1          # EMA weight of the newest observation
    z_threshold: float = 3.0
    patience: int = 3           # consecutive flagged steps before signaling
    warmup: int = 8             # ignore the first N (compile, cache warm)

    mean: float = 0.0
    var: float = 0.0
    count: int = 0
    flagged_streak: int = 0

    def observe(self, step_time_s: float) -> bool:
        """Returns True when mitigation should trigger."""
        self.count += 1
        if self.count <= self.warmup:
            # prime the EMA without flagging
            if self.count == 1:
                self.mean = step_time_s
            self.mean = (1 - self.alpha) * self.mean + self.alpha * step_time_s
            d = step_time_s - self.mean
            self.var = (1 - self.alpha) * self.var + self.alpha * d * d
            return False
        std = math.sqrt(max(self.var, 1e-12))
        z = (step_time_s - self.mean) / max(std, 0.05 * self.mean, 1e-9)
        if z > self.z_threshold:
            self.flagged_streak += 1
        else:
            self.flagged_streak = 0
            self.mean = (1 - self.alpha) * self.mean + self.alpha * step_time_s
            d = step_time_s - self.mean
            self.var = (1 - self.alpha) * self.var + self.alpha * d * d
        return self.flagged_streak >= self.patience

    def reset(self):
        self.flagged_streak = 0


class WorkerFailure(RuntimeError):
    """Raised (or injected) when a host/device drops out mid-step."""


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_s: float = 0.1
    backoff_factor: float = 2.0
    max_backoff_s: float = 30.0

    def delay(self, attempt: int) -> float:
        return min(self.backoff_s * self.backoff_factor**attempt, self.max_backoff_s)


def run_with_restarts(
    step_fn: Callable[[int], None],
    *,
    start_step: int,
    num_steps: int,
    restore_fn: Callable[[], int],
    policy: RestartPolicy | None = None,
    sleep=time.sleep,
) -> dict:
    """Drive ``step_fn(step)`` for ``num_steps``, restarting on WorkerFailure.

    ``restore_fn()`` reloads the latest committed checkpoint and returns the
    step to resume from. Returns run statistics.
    """
    policy = policy or RestartPolicy()
    restarts = 0
    step = start_step
    end = start_step + num_steps
    while step < end:
        try:
            step_fn(step)
            step += 1
        except WorkerFailure:
            if restarts >= policy.max_restarts:
                raise
            sleep(policy.delay(restarts))
            restarts += 1
            step = restore_fn()
    return {"restarts": restarts, "final_step": step}
