"""Measured stage by stage: the int8-resident ``tpu_cnn`` tower against its floors
(``scripts/perf_int8_stages.py``).

Times the cumulative prefixes of ``ops/quant.quant_tpucnn_forward_resident`` on the
patch-major uint8 wire at ``frames_per_step`` frames (default 4096: batch 256 of 16
frames):

1. the stem (the byte map, the K=768 int8 GEMM and its requant: the stem kernel);
2. + ``s0b0`` (two 14²×256 convs and the skip: the int8 conv kernel);
3. + ``down1`` (14² → 7², 256 → 512);
4. + ``s1b0`` (two 7²×512 convs and the skip);
5. + the pool: the whole tower.

The prefixes stop the served forward's own loop (``ops/quant.tpucnn_resident_units``)
after each unit, so prefix 5 is ``quant_tpucnn_forward_resident`` bit for bit. Each conv's
epilogue requantizes for its consumer, as the served program does; the JAX script's
prefixes dequantize after every conv and quantize again at the next. Successive
differences give each stage's time, set against its resident floor
(``utils/roofline.analyze``: the card's int8 peak and memory rate). Each time is
``profile_step.median_ms``.

The tree is the flagship tower's (weights of seed 0, calibrated on 8 frames of N(0, 1)
noise, the ImageNet affine folded into the stem), as the JAX script builds it. The JSON
is the JAX script's: ``{"bench": "int8_resident_stage_decompose", "frames_per_step",
"cumulative_ms", "stages"}``.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.perf_int8_stages [batch_frames=4096] [--cpu]``
"""
from __future__ import annotations

import argparse
import itertools
import json
from typing import Dict, List

import numpy as np
import torch

from ._common import card_line, log, script_device, shown

ITERS, TRIALS = 12, 3
CALIB_FRAMES = 8


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch_frames", nargs="?", type=int, default=4096)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def units(q: Dict) -> List[str]:
    """The tower's units in order: the stem, each stage's downsample and blocks, the pool."""
    stages, blocks = q["layout"]
    names = ["stem"]
    for si in range(stages):
        if si > 0:
            names.append(f"down{si}")
        names += [f"s{si}b{bi}" for bi in range(blocks)]
    return names + ["pool"]


@torch.inference_mode()
def resident_prefix(q: Dict, frames: torch.Tensor, n_units: int) -> torch.Tensor:
    """The output of the first ``n_units`` units of ``quant_tpucnn_forward_resident`` on
    patch-major ``frames``: the served tower's own ``tpucnn_resident_units``, stopped
    there."""
    from ..ops.quant import tpucnn_resident_units

    return next(itertools.islice(tpucnn_resident_units(q, frames), n_units - 1, None))


def stage_floors(q: Dict, frames_per_step: int) -> Dict[str, float]:
    """Each unit's resident floor in ms: the sum over its convs (the pool: 0)."""
    from ..utils.roofline import analyze

    floors = {r["layer"]: r["floor_resident_ms"] for r in analyze(frames_per_step)}
    out = {}
    for name in units(q):
        if name == "pool":
            out[name] = 0.0
        elif name.startswith(("stem", "down")):
            out[name] = floors[name]
        else:
            out[name] = floors[f"{name}a"] + floors[f"{name}b"]
    return out


def build_tree(device, *, calib_frames: int = CALIB_FRAMES) -> Dict:
    """The flagship tower's int8 tree: seed-0 weights, calibrated on ``calib_frames``
    frames of N(0, 1) at 224², the ImageNet affine folded into the stem."""
    from ..bridge import init_params
    from ..entry import flagship_config
    from ..ops.quant import calibrate_tpucnn, quantize_tpucnn, tree_to
    from ..ops.video import IMAGENET_MEAN, IMAGENET_STD

    variables = init_params(flagship_config(), torch.Generator().manual_seed(0))
    params = variables["params"]["video_encoder"]["backbone"]
    stats = variables["batch_stats"]["video_encoder"]["backbone"]
    calib = np.random.default_rng(0).normal(0, 1, size=(calib_frames, 224, 224, 3)).astype(np.float32)
    act = calibrate_tpucnn(params, stats, torch.from_numpy(calib).to(device))
    return tree_to(quantize_tpucnn(params, stats, act, input_fold=(IMAGENET_MEAN, IMAGENET_STD)), device)


def run(frames_per_step: int = 4096, *, cpu: bool = False, iters: int = ITERS, trials: int = TRIALS, tree=None,
        calib_frames: int = CALIB_FRAMES) -> dict:
    """The JAX script's JSON; ``tree`` (default ``build_tree``) is a quantized tree
    with ``input_fold`` on the device."""
    from ..profile_step import median_ms

    device = script_device(cpu)
    card = card_line(device)
    q = tree if tree is not None else build_tree(device, calib_frames=calib_frames)
    p = q["patch"]
    gen = torch.Generator(device=device).manual_seed(0)
    frames = torch.randint(0, 256, (frames_per_step, 224 // p, 224 // p, p * p * 3), generator=gen, device=device,
                           dtype=torch.uint8)
    names = units(q)
    cum = {}
    for n in range(1, len(names) + 1):
        cum[n] = median_ms(resident_prefix, (q, frames, n), trials=trials, iters=iters, device=device)
        log(f"  prefix {n} (… {names[n - 1]}): {shown(cum[n], '.4f')} ms/step")
    floors = stage_floors(q, frames_per_step)
    rows, prev = [], 0.0
    log("| unit | measured ms | floor ms | floor / measured |")
    log("|---|---|---|---|")
    for n, name in enumerate(names, 1):
        label = name if n == 1 else f"+ {name}"
        d = None if cum[n] is None else cum[n] - prev
        prev = cum[n] if cum[n] is not None else prev
        fl = floors[name]
        util = fl / d if d and d > 0 and fl > 0 else None
        rows.append({"unit": label, "measured_ms": d, "floor_ms": fl, "util": util})
        log(f"| {label} | {shown(d, '.4f')} | {fl:.4f} | {shown(util, '.3f')} |")
    log(f"({card})")
    result = {"bench": "int8_resident_stage_decompose", "frames_per_step": frames_per_step,
              "cumulative_ms": {str(k): v for k, v in cum.items()}, "stages": rows}
    print(json.dumps(result))
    return result


def main(argv=None):
    args = parse_args(argv)
    return run(args.batch_frames, cpu=args.cpu)


if __name__ == "__main__":
    main()
