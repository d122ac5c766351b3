"""The flagship serving forward at other ``tpu_cnn`` widths
(``scripts/perf_tpucnn_variants.py``).

Each variant ``w0,w1`` (default ``256,512`` and ``384,512``) is the flagship
configuration (``entry.flagship_config()``) with the tower's two stage widths set so
(one block a stage, the 16×16 patch stem), served whole by ``entry.build_forward`` at
batch 256 on weights of seed 0: the featurizer, the patch-major stem GEMM, the bf16 conv
kernel at both stages (widths in multiples of 64), fusion and the head. The JAX script
times the video encoder alone and adds a constant for the rest; this times the whole
step. Each step is ``profile_step.median_ms``.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.perf_tpucnn_variants [w0,w1 ...] [--cpu]``
"""
from __future__ import annotations

import argparse
import json

import torch

from ._common import card_line, log, per_s, script_device, serving_inputs, shown

VARIANTS = ("256,512", "384,512")
ITERS, TRIALS = 10, 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("variants", nargs="*", default=list(VARIANTS), help="the two stage widths, e.g. 384,512")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def width_backbone(widths) -> str:
    """The name of a one-block ``tpu_cnn`` tower at ``widths``, registered with the
    video models' tables (``tpu_cnn`` itself at its own widths)."""
    from ..models.video import CNN_FEATURE_DIMS, TPU_CNN_CONFIGS

    widths = tuple(int(w) for w in widths)
    if TPU_CNN_CONFIGS["tpu_cnn"] == (widths, 1):
        return "tpu_cnn"
    name = "tpu_cnn_w" + "_".join(map(str, widths))
    TPU_CNN_CONFIGS.setdefault(name, (widths, 1))
    CNN_FEATURE_DIMS.setdefault(name, widths[-1])
    return name


def run(variants=VARIANTS, *, cpu: bool = False, batch: int = 256, iters: int = ITERS, trials: int = TRIALS,
        config=None) -> list:
    """``[{"widths", "backbone", "step_ms", "inf_per_s"}]`` (``config`` default:
    ``entry.flagship_config()``)."""
    import copy

    from ..entry import build_forward, flagship_config
    from ..profile_step import median_ms

    device = script_device(cpu)
    card = card_line(device)
    results = []
    for v in variants:
        widths = tuple(int(w) for w in v.split(","))
        cfg = copy.deepcopy(config) if config is not None else flagship_config()
        cfg.model.video_backbone = width_backbone(widths)
        fn, example = build_forward(cfg, batch, device=device, seed=0)
        args = serving_inputs(example, device)
        ms = median_ms(fn, args, trials=trials, iters=iters, device=device)
        rate = per_s(batch, ms)
        results.append({"widths": list(widths), "backbone": cfg.model.video_backbone, "step_ms": ms, "inf_per_s": rate})
        log(f"tpu_cnn widths={widths}: {shown(ms, '8.3f')} ms/step, {shown(rate, '8.1f')} inf/s at batch {batch} "
            f"({card})")
        del fn, args
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(results))
    return results


def main(argv=None):
    args = parse_args(argv)
    return run(args.variants, cpu=args.cpu)


if __name__ == "__main__":
    main()
