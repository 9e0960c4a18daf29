"""Arithmetic on a run's host timeline and on a device trace's intervals."""

from __future__ import annotations

import math


def rate_per_s(renders, window_start: float) -> float:
    """Σ paths of every render in the window over the time from the window's
    start to the end of its last render. `renders`: [(start, end, paths)]."""
    if not renders:
        raise ValueError("no render finished in the window")
    return sum(r[2] for r in renders) / (renders[-1][1] - window_start)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q % of the
    values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def merge(intervals):
    """Sorted, disjoint union of [(start, end)] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_and_gaps(intervals, w0: float, w1: float):
    """(busy time, [(gap start, gap end)]) of the device intervals clipped to
    the window [w0, w1]."""
    clipped = [(max(s, w0), min(e, w1)) for s, e in intervals if e > w0 and s < w1]
    busy, gaps, t = 0.0, [], w0
    for s, e in merge(clipped):
        if s > t:
            gaps.append((t, s))
        busy += e - s
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return busy, gaps


def idle_pct(busy: float, window: float) -> float:
    return 100.0 * (1.0 - busy / window)
