"""Order statistics the metric readers share."""
from __future__ import annotations

import statistics


def percentile(values: list[float], q: float) -> float | None:
    """The q-th percentile, linear between order statistics (numpy's
    default); ``None`` for no values."""
    if not values:
        return None
    v = sorted(values)
    x = (len(v) - 1) * q / 100
    i = int(x)
    return v[i] if i + 1 >= len(v) else v[i] + (v[i + 1] - v[i]) * (x - i)


def median(values: list[float]) -> float | None:
    return statistics.median(values) if values else None
