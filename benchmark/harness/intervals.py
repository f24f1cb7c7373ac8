"""Interval arithmetic over a trace's device activities (a frozen copy
of the union in the port's bench/profile.py, with clipping and gaps).

An interval is (start, end) in the profiler's microseconds. Activities
of one stream do not overlap, but a copy engine's may overlap a kernel,
so device busy time is the length of the union, never the sum.
"""

from __future__ import annotations


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """Each interval cut to [lo, hi]; the ones outside it dropped."""
    out = []
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e))
    return out


def union(intervals) -> list[tuple[float, float]]:
    """The disjoint intervals covering the same points, in order."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy(intervals) -> float:
    """Total length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, in order."""
    out, at = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
