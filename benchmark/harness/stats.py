"""The arithmetic of the end-to-end metrics: a rate over all the work and
all the time of the window, percentiles over every request, and the spread
that bounds are set from."""

from __future__ import annotations

import math
import statistics


def rate(work: float, seconds: float) -> float:
    """All the work of the window over all of its time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) of every value, by linear
    interpolation between the two nearest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """Interquartile distance over the median, with the quartiles of
    ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
