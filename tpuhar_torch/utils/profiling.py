"""Rolling per-step wall-time statistics and the structured metric stream
(``tpuhar/utils/profiling.py: StepProfiler, MetricsLogger``), copied so that the port
imports nothing of the JAX package."""
from __future__ import annotations

import csv
import json
import time
from pathlib import Path
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


class MetricsLogger:
    """Structured metric stream: ``<name>.jsonl`` (every row) and ``<name>.csv`` (the
    columns of the first row written)."""

    def __init__(self, path, name: str = "metrics"):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.dir / f"{name}.jsonl"
        self.csv_path = self.dir / f"{name}.csv"
        self._csv_keys = None

    def log(self, step: int, metrics: Dict[str, float], **tags) -> None:
        row = {"step": int(step), "time": time.time(), **tags}
        row.update({k: _scalar(v) for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        write_header = False
        if self._csv_keys is None:
            self._csv_keys = list(row)
            write_header = not self.csv_path.exists()
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_keys, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)

    def read(self):
        if not self.jsonl_path.exists():
            return []
        return [json.loads(line) for line in self.jsonl_path.read_text().splitlines()]


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
