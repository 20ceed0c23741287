"""Order statistics of the benchmark."""
from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default): rank (n - 1) * q / 100."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    r = (len(v) - 1) * q / 100.0
    lo = int(r)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (r - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles (Python's
    `statistics.quantiles(values, n=4)`), over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
