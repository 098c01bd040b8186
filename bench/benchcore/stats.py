"""Percentiles and spreads, the benchmark's own copy (the arithmetic of
the port's ``serving/metrics.py`` ``percentile``, frozen here so that a
change to the program cannot move the yardstick)."""
from __future__ import annotations

import statistics

import numpy as np


def percentile(xs, q: float) -> float | None:
    """The ``q``-th percentile, linear interpolation between the two
    nearest order statistics; None on empty input."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    arr = [float(x) for x in xs]
    if not arr:
        return None
    return float(np.percentile(arr, q, method="linear"))


def spread(values) -> float:
    """The distance between the first and third quartiles
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, med, q3 = statistics.quantiles([float(v) for v in values], n=4)
    return (q3 - q1) / abs(med) if med else float("inf")
