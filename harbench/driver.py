"""What every driver shares: the run's context, the device-side window of calls kept
at most ``in_flight`` deep, and a seeded sample of the calls whose outputs are judged.

A driver (``drivers/<name>.py``, named by the cell's file) defines ``Driver`` with
``setup()`` (build, inputs, warm-up: everything before the first timed call),
``window(seconds) -> timeline.Window``, ``attempted``/``failed`` counts, and
``check() -> {name: number}`` (run after the window: it frees the program's state,
then runs the reference).
"""
from __future__ import annotations

import gc
import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import torch

from . import timeline, traffic
from .trace import span


@dataclass
class Context:
    cfg: Mapping  # the configuration file
    workload: Mapping  # the cell's file
    seed: int
    device: torch.device
    fault: Optional[str] = None  # a planted fault, for the tests that prove the comparison

    @property
    def stage(self) -> Mapping:
        return self.cfg["stages"][self.workload["stage"]]

    def generator(self, *keys: int) -> torch.Generator:
        return traffic.generator(self.seed, *keys, device=self.device)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Marker:
    """A point in the device's stream that the host can wait for (a CUDA event; on
    the CPU the work is done when the call returns)."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return time.perf_counter()


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from a seeded generator."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.items[j] = item


def pipelined(device: torch.device, seconds: float, call: Callable[[int], object], units: int, in_flight: int,
              layer: str, keep: Optional[Reservoir] = None) -> timeline.Window:
    """Calls ``call(i)`` back to back, at most ``in_flight`` on the device, until
    ``seconds`` have passed since the window opened; the window closes when the last
    of them completes. ``keep`` samples ``(i, output)``."""
    synchronize(device)
    win = timeline.Window(start=time.perf_counter())
    deadline = win.start + seconds
    queue = deque()
    i = 0
    with span("window"):
        while True:
            issued = time.perf_counter()
            if issued >= deadline:
                break
            with span(layer):
                out = call(i)
            queue.append((issued, Marker(device)))
            if keep is not None:
                keep.offer((i, out))
            while len(queue) >= in_flight:
                t_issued, marker = queue.popleft()
                win.add(t_issued, marker.wait(), units)
            i += 1
        while queue:
            t_issued, marker = queue.popleft()
            win.add(t_issued, marker.wait(), units)
    return win


def release(device: torch.device) -> None:
    """Free what the program held before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def as_host(out: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).detach().float().cpu() for k, v in out.items()}

