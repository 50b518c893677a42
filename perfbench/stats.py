"""The window's arithmetic: percentiles, medians and the union of
intervals, in plain Python so that nothing the program loads can move
them."""
from __future__ import annotations


def percentile(values, q):
    """The q-th percentile (0..100) by linear interpolation between the
    order statistics (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values):
    return percentile(values, 50)


def union(intervals):
    """Merged [(start, end)] of possibly overlapping intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals, lo, hi):
    """Seconds of [lo, hi] that the intervals cover (counted once)."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for a, b in union(intervals))
