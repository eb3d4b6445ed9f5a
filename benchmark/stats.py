"""Arithmetic on samples and on device intervals."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 <= q <= 100) by linear interpolation
    between closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    if not 0 <= q <= 100:
        raise ValueError(f"q = {q}")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``'s quartiles)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2)


def union_length(intervals: Iterable[Tuple[float, float]],
                 lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo,
    hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
