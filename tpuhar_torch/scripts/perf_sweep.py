"""The fused serving forward across towers and batch sizes (``scripts/perf_sweep.py``).

Each variant ``backbone:batch`` (default ``resnet18:512 videomae_small:256``) is the
flagship configuration (``entry.flagship_config()``) with its video tower swapped,
served by ``entry.build_forward`` on weights of seed 0 and device-resident inputs of
the program's own shapes: the patch-major clip for a ``tpu_cnn`` tower, NHWC for the
others, raw IMU counts through the featurizer kernel. A ViT serves as the JAX package
does by default: the tanh GELU, attention without flash. Each step is
``profile_step.median_ms``; it prints inferences/s and ms a step, and the JSON list the
JAX script prints, one entry a variant.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.perf_sweep [variant ...] [--cpu]``
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ._common import card_line, log, per_s, script_device, serving_inputs, shown

VARIANTS = ("resnet18:512", "videomae_small:256")
ITERS, TRIALS = 10, 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("variants", nargs="*", default=list(VARIANTS), help="backbone:batch, e.g. resnet18:512")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def measure(backbone: str, batch: int, device, *, iters: int = ITERS, trials: int = TRIALS, config=None) -> dict:
    """``{"backbone", "batch", "throughput", "step_ms", "build_s"}`` of one variant."""
    import copy

    from ..entry import build_forward, flagship_config
    from ..profile_step import median_ms

    cfg = copy.deepcopy(config) if config is not None else flagship_config()
    cfg.model.video_backbone = backbone
    t0 = time.perf_counter()
    fn, example = build_forward(cfg, batch, device=device, params=None, seed=0)
    build_s = time.perf_counter() - t0
    args = serving_inputs(example, device)
    ms = median_ms(fn, args, trials=trials, iters=iters, device=device)
    thr = per_s(batch, ms)
    log(f"{backbone}:{batch} {shown(thr, '9.1f')} inf/s step {shown(ms, '8.3f')} ms (built in {build_s:.1f} s)")
    del fn, args
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"backbone": backbone, "batch": batch, "throughput": thr, "step_ms": ms, "build_s": build_s}


def run(variants=VARIANTS, *, cpu: bool = False, iters: int = ITERS, trials: int = TRIALS, config=None) -> list:
    """One ``measure`` entry a variant (``config`` default: ``entry.flagship_config()``)."""
    device = script_device(cpu)
    results = []
    for v in variants:
        backbone, batch = v.split(":")
        results.append(measure(backbone, int(batch), device, iters=iters, trials=trials, config=config))
    log(f"({card_line(device)})")
    print(json.dumps(results))
    return results


def main(argv=None):
    args = parse_args(argv)
    return run(args.variants, cpu=args.cpu)


if __name__ == "__main__":
    main()
