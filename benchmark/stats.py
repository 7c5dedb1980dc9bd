"""The benchmark's arithmetic: rates and interval unions, on plain numbers
(host seconds or nanoseconds of a trace)."""
from __future__ import annotations

from typing import Iterable, List, Tuple


def rate(count: float, seconds: float) -> float:
    """``count`` per second over ``seconds`` (> 0)."""
    if seconds <= 0.0:
        raise ValueError("a rate needs a window longer than 0 s")
    return count / seconds


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint intervals covering ``intervals`` (start, end), in order."""
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """``intervals`` cut to [lo, hi], the empty ones dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if min(e, hi) > max(s, lo)]


def covered(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of [lo, hi] that ``intervals`` cover, each point once."""
    return sum(e - s for s, e in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The parts of [lo, hi] that no interval covers, in order."""
    out, at = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
