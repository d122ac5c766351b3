"""Arithmetic over a measured window: rates, tails, and the device's busy and idle time
from the intervals of its operations. Pure Python, so that the tests hold it on
synthetic timelines.

A window opens at ``start`` and closes when the last piece of work issued before the
deadline completes: a rate is every completed unit over all that time, and a tail is
the tail of every request. A window in which nothing completed gives no number at all:
``NoWork`` is raised, never a rate of 0 or a statistic of other trials.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple


class NoWork(RuntimeError):
    """The window completed no work: there is nothing to report."""


@dataclass
class Window:
    """Completions on the host's clock (seconds): ``done`` holds ``(issued, completed,
    units)`` for each call, request or step, in the order issued."""

    start: float
    done: List[Tuple[float, float, int]] = field(default_factory=list)

    def add(self, issued: float, completed: float, units: int) -> None:
        if completed < issued or issued < self.start:
            raise ValueError(f"a completion at {completed} before its issue at {issued} or the window's start")
        self.done.append((issued, completed, int(units)))

    @property
    def end(self) -> float:
        if not self.done:
            raise NoWork("no work completed in the window")
        return max(c for _, c, _ in self.done)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def units(self) -> int:
        return sum(u for _, _, u in self.done)

    def rate(self) -> float:
        """Completed units per second over the whole window."""
        seconds, units = self.seconds, self.units
        if units <= 0 or seconds <= 0:
            raise NoWork("no work completed in the window")
        return units / seconds

    def latencies(self) -> List[float]:
        if not self.done:
            raise NoWork("no request completed in the window")
        return [c - i for i, c, _ in self.done]


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between order statistics
    (numpy's default), over every value."""
    if not values:
        raise NoWork("no values")
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def union(intervals: Sequence[Tuple[float, float]], start: float, end: float) -> List[Tuple[float, float]]:
    """The intervals clipped to ``[start, end]`` and merged where they overlap."""
    merged: List[List[float]] = []
    for a, b in sorted((max(a, start), min(b, end)) for a, b in intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_seconds(intervals, start: float, end: float) -> float:
    """Time in ``[start, end]`` in which at least one interval is open: overlapping
    operations count once."""
    return sum(b - a for a, b in union(intervals, start, end))


def gaps(intervals, start: float, end: float) -> List[Tuple[float, float]]:
    """The stretches of ``[start, end]`` that no interval covers, before the first,
    between, and after the last."""
    out, t = [], start
    for a, b in union(intervals, start, end):
        if a > t:
            out.append((t, a))
        t = b
    if end > t:
        out.append((t, end))
    return out


def idle_pct(intervals, start: float, end: float) -> float:
    """100 × (1 − busy ÷ window)."""
    if end <= start:
        raise NoWork("an empty window")
    return 100.0 * (1.0 - busy_seconds(intervals, start, end) / (end - start))
