"""Rolling per-step wall-time statistics (``tpuhar/utils/profiling.py: StepProfiler``),
copied so that the port imports nothing of the JAX package."""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np


class StepProfiler:
    """Rolling per-step timing with percentile summaries (no device sync itself —
    call ``stop`` after you've blocked on the step's outputs)."""

    def __init__(self, window: int = 200):
        self.window = window
        self._times: list = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            return
        self._times.append(time.perf_counter() - self._t0)
        self._t0 = None
        if len(self._times) > self.window:
            self._times.pop(0)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        a = np.asarray(self._times) * 1e3
        return {
            "steps": len(a),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p90_ms": float(np.percentile(a, 90)),
            "p99_ms": float(np.percentile(a, 99)),
        }
