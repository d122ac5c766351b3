"""The int8-resident flagship against the bf16 one (``scripts/perf_quant.py``).

Both serving forwards of ``entry.flagship_config()`` on the same weights (seed 0): the
bf16 program (``entry.build_forward``: the featurizer and the bf16 conv kernels) and
the int8-resident program (``entry.build_int8_forward``, calibrated on the first two
clips: the featurizer, the uint8 stem and the int8 conv kernels), on the same
device-resident patch-major clips at the batch given (default 256). Each time is
``profile_step.median_ms``; it prints ms a step, inferences/s and the speed-up.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.perf_quant [batch=256] [--cpu]``
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ._common import card_line, log, per_s, script_device, serving_inputs, shown

ITERS, TRIALS = 10, 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=256)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def run(batch: int = 256, *, cpu: bool = False, iters: int = ITERS, trials: int = TRIALS, config=None) -> dict:
    """``{"bench": "quant", "batch", "device", "bf16_ms", "int8_ms", "bf16_inf_per_s",
    "int8_inf_per_s", "speedup"}`` (``config`` default: ``entry.flagship_config()``)."""
    from ..bridge import init_params
    from ..entry import build_forward, build_int8_forward, flagship_config
    from ..profile_step import median_ms

    device = script_device(cpu)
    card = card_line(device)
    cfg = config or flagship_config()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    fn, example = build_forward(cfg, batch, device=device, params=params)
    imu, video = serving_inputs(example, device)
    d = cfg.data
    H, W = d.video_resize
    calib = video[:2].reshape(2, d.video_frames_per_window, H, W, 3).cpu().numpy()  # NHWC, the same bytes
    log("building the int8-resident forward (calibration, quantization, logit recalibration) ...")
    qfn, _ = build_int8_forward(cfg, batch, device=device, params=params, calib_clips=np.ascontiguousarray(calib),
                                resident=True)
    t_bf16 = median_ms(fn, (imu, video), trials=trials, iters=iters, device=device)
    t_int8 = median_ms(qfn, (imu, video), trials=trials, iters=iters, device=device)
    result = {
        "bench": "quant", "batch": batch, "device": card, "bf16_ms": t_bf16, "int8_ms": t_int8,
        "bf16_inf_per_s": per_s(batch, t_bf16), "int8_inf_per_s": per_s(batch, t_int8),
        "speedup": None if None in (t_bf16, t_int8) else t_bf16 / t_int8,
    }
    log(f"bf16 flagship: {shown(t_bf16, '8.3f')} ms/step ({shown(result['bf16_inf_per_s'], '7.0f')} inf/s)")
    log(f"int8 flagship: {shown(t_int8, '8.3f')} ms/step ({shown(result['int8_inf_per_s'], '7.0f')} inf/s), "
        f"speed-up {shown(result['speedup'], '.2f')}x ({card})")
    print(json.dumps(result))
    return result


def main(argv=None):
    args = parse_args(argv)
    return run(args.batch, cpu=args.cpu)


if __name__ == "__main__":
    main()
