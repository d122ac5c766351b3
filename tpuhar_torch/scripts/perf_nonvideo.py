"""The flagship serving step outside the video tower (``scripts/perf_nonvideo.py``).

Times, each on its own on device-resident inputs at the batch given (default 256):

- ``featurize``: the fused window featurizer on raw counts (the featurizer kernel);
- ``fusion``: ``FusionClassifier.fuse_with_tokens``: the IMU encoder, two rounds of
  cross-attention and the head, on featurized windows and video tokens;
- ``proj``: the video feature → token projection GEMM (``(B, T, 512) @ (512, d)``, f32);
- ``nonvideo_all``: featurize, project and fuse in one program: what the step pays
  outside the tower.

Weights are drawn from seed 0 (``entry.flagship_config()``, bf16 compute); each time is
``profile_step.median_ms``. The JSON is the JAX script's, ``{"bench":
"nonvideo_decompose", "batch", "ms"}``.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.perf_nonvideo [batch=256] [--cpu]``
"""
from __future__ import annotations

import argparse
import json

import torch

from ._common import card_line, log, script_device, shown

FEATURE_WIDTH = 512  # the tpu_cnn tower's feature: widths[-1]
ITERS, TRIALS = 20, 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=256)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def run(batch: int = 256, *, cpu: bool = False, iters: int = ITERS, trials: int = TRIALS, config=None) -> dict:
    """``{"bench": "nonvideo_decompose", "batch", "ms": {unit: ms}}`` (``config``
    default: ``entry.flagship_config()``)."""
    from ..bridge import init_params, load_variables
    from ..entry import featurize, flagship_config
    from ..models.crossmodal import FusionClassifier
    from ..profile_step import median_ms

    device = script_device(cpu)
    card = card_line(device)
    cfg = config or flagship_config()
    d, m = cfg.data, cfg.model
    T = d.video_frames_per_window
    dtype = getattr(torch, m.compute_dtype)
    model = load_variables(FusionClassifier(cfg, dtype=dtype),
                           init_params(cfg, torch.Generator().manual_seed(0))).to(device).eval()
    gen = torch.Generator(device=device).manual_seed(0)
    imu_raw = torch.randn((batch, d.imu_window_size, d.imu_channels), generator=gen, device=device) * 8000.0
    imu_feat = torch.randn((batch, d.imu_channels, d.imu_window_size), generator=gen, device=device)
    tokens = torch.randn((batch, T, m.video_d_model), generator=gen, device=device).to(dtype)
    feats = torch.randn((batch, T, FEATURE_WIDTH), generator=gen, device=device)
    proj_k = torch.randn((FEATURE_WIDTH, m.video_d_model), generator=gen, device=device) * 0.02
    proj_b = torch.zeros(m.video_d_model, device=device)

    def proj(x):
        return x @ proj_k + proj_b

    def nonvideo_all(x):
        return model.fuse_with_tokens(featurize(cfg, x), proj(feats).to(dtype))[0]

    units = {
        "featurize": (lambda x: featurize(cfg, x), imu_raw),
        "fusion": (lambda x: model.fuse_with_tokens(x, tokens)[0], imu_feat),
        "proj": (proj, feats),
        "nonvideo_all": (nonvideo_all, imu_raw),
    }
    ms = {}
    with torch.inference_mode():
        for name, (fn, x) in units.items():
            ms[name] = median_ms(fn, (x,), trials=trials, iters=iters, device=device)
            log(f"  {name}: {shown(ms[name], '.4f')} ms/step")
    log(f"({card})")
    result = {"bench": "nonvideo_decompose", "batch": batch, "ms": ms}
    print(json.dumps(result))
    return result


def main(argv=None):
    args = parse_args(argv)
    return run(args.batch, cpu=args.cpu)


if __name__ == "__main__":
    main()
