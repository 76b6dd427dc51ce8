"""The metric arithmetic: rates over the whole window and percentiles
over every frame of it."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics, over all values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(amount: float, seconds: float) -> float:
    """``amount`` per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError("empty window")
    return amount / seconds

