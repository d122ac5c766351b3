"""Where the flagship serving step's time goes (``scripts/perf_decompose.py``).

Times, each on its own at the batch given (default 256), on device-resident inputs:

- ``full``: raw IMU counts and the patch-major uint8 clip → logits and OOD scores
  (``entry.build_forward(flagship_config())``: the featurizer kernel, the bf16 conv
  kernel);
- ``norm``: the uint8 NHWC clip → the normalized f32 clip (``ops/video.normalize_clip``);
- ``video``: the normalized clip → the video tokens (the ``tpu_cnn`` encoder on NHWC
  frames, its stem a stride-16 conv);
- ``norm_video``: the uint8 clip through both;
- ``video_folded``: the tower as ``full`` serves it: the ImageNet affine folded into
  the stem, the patch-major clip in;
- ``imu_fuse``: featurization, the IMU encoder, the cross-attention and the head on
  video tokens made elsewhere (``FusionClassifier.fuse_with_tokens``).

The JAX script takes ``imu+fuse`` as ``full`` less ``norm+video``; the port's full step
folds the normalization into the stem, so it times the fusion side itself. Each time is
``profile_step.median_ms`` (CUDA events after a warm-up, the median of ``trials``).
Weights are drawn from seed 0.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.perf_decompose [batch=256] [--cpu]``
"""
from __future__ import annotations

import argparse
import json

import torch

from ._common import card_line, log, per_s, script_device, serving_inputs, shown

ITERS, TRIALS = 20, 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=256)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def run(batch: int = 256, *, cpu: bool = False, iters: int = ITERS, trials: int = TRIALS, config=None) -> dict:
    """``{"bench": "flagship_decompose", "batch", "device", "ms": {unit: ms}}``
    (``config`` default: ``entry.flagship_config()``)."""
    from ..bridge import init_params, load_variables
    from ..entry import build_forward, featurize, flagship_config
    from ..models.crossmodal import FusionClassifier
    from ..ops.fold import fold_normalization
    from ..ops.video import clip_stats, normalize_clip
    from ..profile_step import median_ms

    device = script_device(cpu)
    card = card_line(device)
    cfg = config or flagship_config()
    dtype = getattr(torch, cfg.model.compute_dtype)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    full, example = build_forward(cfg, batch, device=device, params=params)
    imu, video_pm = serving_inputs(example, device)
    d = cfg.data
    H, W = d.video_resize
    video = video_pm.reshape(batch, d.video_frames_per_window, H, W, 3)  # the same bytes, NHWC
    mean, std = clip_stats(device)
    model = load_variables(FusionClassifier(cfg, dtype=dtype), params).to(device).eval()
    folded = load_variables(FusionClassifier(cfg, dtype=dtype), fold_normalization(params, cfg)[0]).to(device).eval()
    tokens = torch.randn((batch, d.video_frames_per_window, cfg.model.video_d_model), device=device).to(dtype)
    normalized = normalize_clip(video, mean=mean, std=std)

    def video_tokens(encoder, clip):
        return encoder(clip)[1]

    units = {
        "full": (full, (imu, video_pm)),
        "norm": (lambda v: normalize_clip(v, mean=mean, std=std).sum(), (video,)),
        "video": (lambda x: video_tokens(model.video_encoder, x), (normalized,)),
        "norm_video": (lambda v: video_tokens(model.video_encoder, normalize_clip(v, mean=mean, std=std)), (video,)),
        "video_folded": (lambda v: video_tokens(folded.video_encoder, v.to(dtype)), (video_pm,)),
        "imu_fuse": (lambda x, t: model.fuse_with_tokens(featurize(cfg, x), t), (imu, tokens)),
    }
    ms = {}
    with torch.inference_mode():
        for name, (fn, args) in units.items():
            ms[name] = median_ms(fn, args, trials=trials, iters=iters, device=device)
            log(f"{name:13}: {shown(ms[name], '9.3f')} ms"
                + (f" ({shown(per_s(batch, ms[name]), '.0f')} inf/s)" if name == "full" else ""))
    log(f"({card})")
    result = {"bench": "flagship_decompose", "batch": batch, "device": card, "ms": ms}
    print(json.dumps(result))
    return result


def main(argv=None):
    args = parse_args(argv)
    return run(args.batch, cpu=args.cpu)


if __name__ == "__main__":
    main()
