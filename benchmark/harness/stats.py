"""Arithmetic of the measurements: percentiles and the union of device
intervals."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank p-th percentile (0 < p <= 100): the smallest value
    with at least p% of the values at or below it. A failed request enters
    as math.inf, slower than any other, and the result is inf where the rank
    lands on one."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(s)))
    return s[rank - 1]


def union_length(intervals: Iterable[Tuple[float, float]], lo: float = -math.inf, hi: float = math.inf) -> float:
    """Total length covered by the intervals [start, end), each clipped to
    [lo, hi): overlapping intervals count once."""
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


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers, in order."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]
