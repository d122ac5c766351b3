"""Pieces the scripts share: logging, the device and the card's line, the inputs of the
timing scripts, the leave-one-out checkpoints and the scoring of a split."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils import resolve_device


def log(message) -> None:
    print(message, file=sys.stderr, flush=True)


def script_device(cpu: bool) -> torch.device:
    """The card, or the CPU where the caller asked for it (``--cpu``); raises without a
    card rather than falling back."""
    return resolve_device("cpu" if cpu else "cuda", "this workflow (pass --cpu for the CPU)")


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them, or "cpu"; every time a timing script prints
    stands beside it."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def shown(x, spec: str = ".3f") -> str:
    """``x`` formatted with ``spec``, or "null" where no trial gave it."""
    return "null" if x is None else format(x, spec)


def per_s(n: float, ms):
    """``n`` a second at ``ms`` a step, or None where no trial gave ``ms``."""
    return None if ms is None else n / ms * 1e3


def serving_inputs(example_args, device, *, seed: int = 0):
    """Inputs of the shapes and dtypes of a serving forward's ``example_args``, drawn on
    ``device``: raw IMU counts ~ N(0, 8000²) and uniform uint8 pixels."""
    imu_ex, video_ex = example_args
    gen = torch.Generator(device=device).manual_seed(seed)
    imu = torch.randn(tuple(imu_ex.shape), generator=gen, device=device) * 8000.0
    video = torch.randint(0, 256, tuple(video_ex.shape), generator=gen, device=device, dtype=torch.uint8)
    return imu, video


def find_checkpoint(ckpt_dir: Path, names: Sequence[str]) -> Optional[Path]:
    """The first of ``ckpt_dir / name`` that holds a checkpoint (``<name>.pt``)."""
    return next((ckpt_dir / n for n in names if (ckpt_dir / n).with_suffix(".pt").exists()), None)


def restore_fusion_variables(config, path) -> dict:
    """The flax-layout variables of the ``FusionClassifier`` checkpoint at ``path``,
    restored into a task built on the host."""
    from ..bridge import init_params, variables_to_numpy
    from ..models.crossmodal import FusionClassifier
    from ..train import checkpoint as ckpt
    from ..train.factory import build_fusion_task

    params = init_params(config, torch.Generator().manual_seed(0), FusionClassifier)
    task = build_fusion_task(config, 1, params, device="cpu")
    ckpt.restore_checkpoint(path, task.state, model_only=True)
    return variables_to_numpy(task.model)


def fusion_model(config, variables, device):
    """``FusionClassifier(config)`` in its compute dtype holding ``variables``, on
    ``device``, in eval mode: the JAX package's ``model.apply(variables, ...)``."""
    from ..bridge import load_variables
    from ..models.crossmodal import FusionClassifier

    dtype = getattr(torch, config.model.compute_dtype)
    return load_variables(FusionClassifier(config, dtype=dtype), variables).to(device).eval()


def score_split(df, config, fn: Callable, batch_size: int, device, *, labels: bool = False):
    """``(logits, embeddings[, labels])`` of the valid rows of ``df``, numpy f32, with
    ``fn(imu, video_u8) -> (logits, embeddings)`` over its fusion batches on ``device``."""
    from ..data.loader import BatchLoader

    out = ([], [], [])
    loader = BatchLoader(df, config, mode="fusion", batch_size=batch_size, prefetch=0, device=device)
    with torch.inference_mode():
        for b in loader:
            lg, em = fn(b["imu"], b["video"])
            n = int(b["n_valid"])
            out[0].append(lg.float().cpu().numpy()[:n])
            out[1].append(em.float().cpu().numpy()[:n])
            out[2].append(b["label"].cpu().numpy()[:n])
    arrays = tuple(np.concatenate(parts) for parts in out)
    return arrays if labels else arrays[:2]
