"""Training-side fault tolerance — re-exports of the shared primitives.

The straggler detector and bounded-backoff restart policy live in
:mod:`repro_torch.core.retry` (the serving tick loop uses them too); this
module keeps the reference's training import path.
"""
from __future__ import annotations

from repro_torch.core.retry import (  # noqa: F401
    RestartPolicy,
    StragglerDetector,
    WorkerFailure,
    run_with_restarts,
)

__all__ = ["RestartPolicy", "StragglerDetector", "WorkerFailure", "run_with_restarts"]
