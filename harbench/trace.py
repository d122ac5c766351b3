"""The traced window: ``torch.profiler`` events kept in memory and reduced to the
device's operations, their busy time, and the host op that ran in each idle gap.

The window is the benchmark's own span ``harbench:window``; busy time is the union of
the device operations' intervals inside it (kernels, copies and sets, overlapping ones
counted once). An idle gap is named by the innermost host op of the window's thread
that was open at its middle. The benchmark's spans around the calls into each layer
(``harbench:<layer>.<call>``) are recorded with ``span``.
"""
from __future__ import annotations

import contextlib
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from . import timeline

PREFIX = "harbench:"
WINDOW = PREFIX + "window"


def span(name: str):
    """A named host span in the trace (a no-op when nothing records). The profiler
    also draws it on the device's timeline, where it is no operation and is skipped."""
    return torch.profiler.record_function(name if name.startswith(PREFIX) else PREFIX + name)


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and parameter list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:limit]


class Trace:
    """What a traced window holds: ``device`` ``[(name, start_s, end_s)]``, ``host``
    ``[(name, start_s, end_s)]`` of the window's thread, and the window's bounds."""

    def __init__(self, device, host, start: float, end: float):
        self.device, self.host, self.start, self.end = device, host, start, end

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return timeline.busy_seconds([(a, b) for _, a, b in self.device], self.start, self.end)

    def idle_pct(self) -> float:
        return timeline.idle_pct([(a, b) for _, a, b in self.device], self.start, self.end)

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Device time and launches of the operations whose name holds ``pattern``
        (a regular expression) inside the window."""
        rx = re.compile(pattern)
        hits = [(a, b) for n, a, b in self.device if rx.search(n) and a >= self.start and b <= self.end]
        return sum(b - a for a, b in hits), len(hits)

    def device_ops(self, top: int = 10) -> List[List]:
        by = defaultdict(float)
        for n, a, b in self.device:
            by[short_name(n)] += min(b, self.end) - max(a, self.start)
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds summed by the host op open at each gap's middle."""
        gaps = sorted(timeline.gaps([(a, b) for _, a, b in self.device], self.start, self.end),
                      key=lambda g: (g[0] + g[1]) / 2)
        by = defaultdict(float)
        stack: List[Tuple[str, float, float]] = []
        i = 0
        for a, b in gaps:
            mid = (a + b) / 2
            while i < len(self.host) and self.host[i][1] <= mid:
                ev = self.host[i]
                while stack and stack[-1][2] <= ev[1]:
                    stack.pop()
                stack.append(ev)
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            by[stack[-1][0] if stack else "(no host op)"] += b - a
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block when ``enabled``; yields a holder whose ``.trace`` is the
    reduced ``Trace`` once the block ends."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.trace = reduce(prof)


def _events(prof):
    try:
        return prof.profiler.kineto_results.events()
    except AttributeError:  # older profilers: the parsed events
        return None


def _annotation(e) -> bool:
    """A user annotation drawn on the device's timeline (not an operation)."""
    try:
        return bool(e.is_user_annotation())
    except AttributeError:
        return False


def reduce(prof) -> Optional[Trace]:
    """The window's device operations and its thread's host ops from a profiler."""
    raw = _events(prof)
    if raw is None:
        raise RuntimeError("the profiler kept no kineto events")
    win = [e for e in raw if e.name() == WINDOW and e.device_type() == torch.autograd.DeviceType.CPU]
    if not win:
        raise RuntimeError(f"no {WINDOW} span in the trace")
    w = max(win, key=lambda e: e.duration_ns())
    start, end = w.start_ns() * 1e-9, (w.start_ns() + w.duration_ns()) * 1e-9
    thread = w.start_thread_id()
    device, host = [], []
    for e in raw:
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if b < start or a > end:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not (e.name().startswith(PREFIX) or _annotation(e)):
                device.append((e.name(), a, b))
        elif e.start_thread_id() == thread and e.name() != WINDOW:
            host.append((e.name(), a, b))
    host.sort(key=lambda h: (h[1], -h[2]))
    return Trace(device, host, start, end)
