"""The benchmark's arithmetic over host times and device intervals."""

from __future__ import annotations

import math


def percentile(values, q):
    """The nearest-rank q-th percentile (0 < q <= 100) of all values: the
    least value with at least q% of the values at or below it. A failed
    request enters as math.inf, so it counts as missing any limit."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(work, t_start, t_end):
    """Work completed per second over the window from its start to the end
    of its last completed item; a stall inside the window counts."""
    span = t_end - t_start
    if span <= 0.0:
        raise ValueError("a window of no length")
    return work / span


def merge_intervals(intervals):
    """The union of (start, end) intervals as sorted, disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip_intervals(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_time(intervals, lo, hi):
    """Length of the union of the intervals inside [lo, hi]."""
    return sum(e - s for s, e in merge_intervals(clip_intervals(intervals, lo, hi)))


def idle_gaps(intervals, lo, hi):
    """The gaps inside [lo, hi] that no interval covers, as (start, end)."""
    gaps, at = [], lo
    for s, e in merge_intervals(clip_intervals(intervals, lo, hi)):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps
