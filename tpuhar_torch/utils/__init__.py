"""Host-side utilities of the port (``tpuhar/utils/__init__.py``): seeding, device
introspection, parameter counts over a flax-layout tree or an ``nn.Module``, the dataset
layout check, meters and timers, and results summaries. ``profiling`` holds the serving
engine's rolling latency profile, the trainers' metric stream and the trace scopes.

Devices are ``torch.device``s: ``resolve_device`` turns a caller's ``device`` into one and
raises for ``"cuda"`` without a card, so that no entry point carries on on the CPU
unasked.
"""
from __future__ import annotations

import json
import random
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------------
# Seeding
# ---------------------------------------------------------------------------------
def set_seed(seed: int = 42) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators and return a CPU
    ``torch.Generator`` seeded ``seed`` (``train.factory.default_generator``'s seeding):
    the port's counterpart of the JAX package's root key, split per use with
    ``train.factory.split_seeds``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(int(seed))


# ---------------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------------
def resolve_device(device, who: str = "this entry point") -> torch.device:
    """``device`` as a ``torch.device``: ``"cuda"`` (the current card unless an index is
    given) raises ``RuntimeError`` without a CUDA device; ``"cpu"`` is the CPU; any
    other type raises ``ValueError``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} on 'cuda' needs a CUDA device and torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"{who} runs on 'cuda' or 'cpu', not {device!r}")
    return dev


def get_devices(platform: Optional[str] = None) -> List[torch.device]:
    """The CUDA devices (``platform`` None, "cuda" or "gpu"), else the CPU; ``"cpu"``
    asks for the CPU."""
    if platform != "cpu" and torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def describe_devices() -> str:
    """``"<count>x <kind>"`` per kind of ``get_devices()``, e.g. "1x NVIDIA H100 80GB HBM3"."""
    kinds: Dict[str, int] = {}
    for d in get_devices():
        kind = torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"
        kinds[kind] = kinds.get(kind, 0) + 1
    return ", ".join(f"{n}x {k}" for k, n in kinds.items())


# ---------------------------------------------------------------------------------
# Model introspection
# ---------------------------------------------------------------------------------
def _leaves(params):
    """The arrays of a flax-layout tree (nested mappings), or an ``nn.Module``'s
    parameters."""
    if isinstance(params, torch.nn.Module):
        yield from params.parameters()
    elif isinstance(params, Mapping):
        for value in params.values():
            yield from _leaves(value)
    elif params is not None:
        yield params


def count_parameters(params) -> int:
    """Elements of every parameter: the leaves of a flax-layout tree (numpy arrays or
    tensors) or an ``nn.Module``'s parameters."""
    return int(sum(int(np.prod(x.shape)) for x in _leaves(params)))


def param_bytes(params) -> int:
    return int(sum(
        int(np.prod(x.shape)) * (x.element_size() if isinstance(x, torch.Tensor) else np.dtype(x.dtype).itemsize)
        for x in _leaves(params)
    ))


def print_model_info(name: str, params) -> None:
    print(f"{name}: {count_parameters(params):,} parameters ({param_bytes(params) / 1e6:.2f} MB)")


# ---------------------------------------------------------------------------------
# Dataset path validation
# ---------------------------------------------------------------------------------
def check_dataset_paths(config) -> Dict[str, bool]:
    """The raw dataset's layout; the video directory is optional."""
    base = Path(config.paths.base_input)
    status = {
        "base_input": base.exists(),
        "train_file": (base / config.paths.train_file).exists(),
        "val_file": (base / config.paths.val_file).exists(),
        "test_file": (base / config.paths.test_file).exists(),
        "sensor_dir": (base / config.paths.sensor_dir).exists(),
        "video_dir": (base / config.paths.video_dir).exists(),  # optional
    }
    status["ok"] = all(status[k] for k in status if k != "video_dir")
    return status


# ---------------------------------------------------------------------------------
# Timing and meters
# ---------------------------------------------------------------------------------
class AverageMeter:
    """Running mean tracker."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def format_time(seconds: float) -> str:
    """A human-readable duration."""
    seconds = float(seconds)
    if seconds < 60:
        return f"{seconds:.1f}s"
    if seconds < 3600:
        return f"{int(seconds // 60)}m {seconds % 60:.0f}s"
    return f"{int(seconds // 3600)}h {int((seconds % 3600) // 60)}m"


def estimate_training_time(steps_per_epoch: int, epochs: int, secs_per_step: float) -> str:
    return format_time(steps_per_epoch * epochs * secs_per_step)


class StepTimer:
    """Per-step wall-clock timer whose first ``warmup`` steps are left out (the caller
    synchronizes the device before ``stop``)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list = []
        self._t0 = None
        self._step = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        dt = time.perf_counter() - self._t0
        self._step += 1
        if self._step > self.warmup:
            self._times.append(dt)

    @property
    def mean(self) -> float:
        return float(np.mean(self._times)) if self._times else 0.0

    @property
    def p50(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0


# ---------------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------------
def save_config(config, path) -> None:
    config.save(path)


def create_results_summary(results: dict, path) -> None:
    """A JSON results summary; numpy scalars and arrays and tensors as numbers and lists."""
    with open(path, "w") as f:
        json.dump(results, f, indent=2, default=_json_default)


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    return str(o)


def format_metric_table(metrics: Dict[str, float], title: str = "") -> str:
    """A console table of ``metrics``."""
    lines = [title] if title else []
    width = max((len(k) for k in metrics), default=0)
    for k, v in metrics.items():
        lines.append(f"  {k:<{width}} : {v:8.3f}")
    return "\n".join(lines)
