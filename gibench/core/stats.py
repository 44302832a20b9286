"""Statistics of a run's host times."""

from __future__ import annotations

import math


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of ``values`` do not exceed."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]
