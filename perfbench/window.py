"""Window arithmetic: rates, tails and the union of device intervals."""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class Request:
    batch: int
    start: float          # host clock, s
    end: float
    audio_s: float        # seconds of audio the request carries
    ok: bool = True       # the call returned and its outputs were right


def rate(requests: list, window_s: float) -> float:
    """Seconds of audio of every request in the window over the window's
    wall seconds: all the work over all the time."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return sum(r.audio_s for r in requests) / window_s


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of every value:
    the smallest value with at least q % of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def union(intervals, lo: float = -math.inf, hi: float = math.inf) -> list:
    """The disjoint, sorted union of (start, end) intervals clipped to
    [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def covered(intervals, lo: float = -math.inf, hi: float = math.inf) -> float:
    """The length of the union of the intervals within [lo, hi]."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in union(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
