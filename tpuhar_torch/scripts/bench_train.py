"""Training-step throughput: the cross-modal pretraining step and the fusion finetune
step (forward, backward, clipping and AdamW) of the flagship configuration
(``scripts/bench_train.py``).

Each step is ``entry.build_pretrain_task`` / ``entry.build_fusion_task`` on
``entry.flagship_config()`` (the ``tpu_cnn`` tower, bf16 compute with f32 master
weights), with weights drawn from seed 0, on one batch drawn from
``np.random.default_rng(0)`` (z-scored IMU windows, uniform uint8 clips, labels for the
fusion step), as the JAX script draws it. ``tpu_cnn``'s train mode runs every conv
through cuDNN: no hand kernel runs here. Each step is timed with
``profile_step.median_ms`` (CUDA events after a warm-up step, the median of
``trials``); it prints ms a step and clips/s.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.bench_train [batch=32] [--cpu]``
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ._common import card_line, log, per_s, script_device, shown

STEPS = 10  # timed steps a trial (the JAX script's K)
TRIALS = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=32)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def train_batch(cfg, batch: int, device, *, labels: bool) -> dict:
    """One batch drawn from ``default_rng(0)`` as the JAX script draws it, on ``device``."""
    d = cfg.data
    H, W = d.video_resize
    npr = np.random.default_rng(0)
    out = {
        "imu": npr.normal(size=(batch, d.imu_channels, d.imu_window_size)).astype(np.float32),
        "video": (npr.random((batch, d.video_frames_per_window, H, W, 3)) * 255).astype(np.uint8),
        "n_valid": np.int32(batch),
    }
    if labels:
        out["label"] = npr.integers(0, cfg.model.num_classes, batch).astype(np.int64)
    return {k: torch.as_tensor(v).to(device) for k, v in out.items()}


def run(batch: int = 32, *, cpu: bool = False, steps: int = STEPS, trials: int = TRIALS, config=None) -> dict:
    """``{"bench", "batch", "device", "steps": {name: {"ms", "clips_per_s"}}}`` of the
    two train steps at ``batch`` (``config`` default: ``entry.flagship_config()``)."""
    from ..entry import build_fusion_task, build_pretrain_task, flagship_config
    from ..profile_step import median_ms

    device = script_device(cpu)
    cfg = config or flagship_config()
    card = card_line(device)
    result = {"bench": "train_step", "batch": batch, "device": card, "steps": {}}
    for name, build, labels in (("crossmodal_pretrain", build_pretrain_task, False),
                                ("fusion_finetune", build_fusion_task, True)):
        task = build(cfg, device=device, seed=0, steps_per_epoch=100)
        data = train_batch(cfg, batch, device, labels=labels)
        dropout = torch.Generator(device=device).manual_seed(1)
        ms = median_ms(lambda: task.train_step(task.state, data, dropout), (), trials=trials, iters=steps,
                       warmup=1, device=device)
        result["steps"][name] = {"ms": ms, "clips_per_s": per_s(batch, ms)}
        log(f"{name}: {shown(ms)} ms/step ({shown(per_s(batch, ms), '.1f')} clips/s) batch={batch} ({card})")
        del task, data
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


def main(argv=None):
    args = parse_args(argv)
    return run(args.batch, cpu=args.cpu)


if __name__ == "__main__":
    main()
