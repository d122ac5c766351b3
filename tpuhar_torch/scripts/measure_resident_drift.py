"""The resident-against-baseline int8 logit drift of ResNet-18 over seeds
(``scripts/measure_resident_drift.py``).

The resident int8 program keeps activations int8 between blocks, which adds one
rounding on the skip path of each residual block against the baseline int8 program
(``ops/quant.quant_resnet18_forward_resident``). On random weights the logits are
near-degenerate noise, so a correlation bound sits near its threshold; this prints, per
seed, (a) the Pearson correlation of the two engines' logits and (b) the relative RMS
drift ``rms(res − base) / rms(base − mean(base))``, and their distribution.

Each seed's weights are ``bridge.init_params`` from a CPU generator seeded with it (the
JAX script draws ``PRNGKey(seed)``: other weights, the same distribution). Each seed
builds a baseline and a resident ``InferenceEngine`` at batch 4, calibrated on the first
two of its four clips.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.measure_resident_drift [n_seeds=12] [--cpu]``
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ._common import log, script_device

BATCH, FRAMES, SIZE = 4, 4, 32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_seeds", nargs="?", type=int, default=12)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def drift_config():
    """The JAX script's ``_cfg()``: ResNet-18, 5 classes, f32, 4 frames of 32²."""
    from ..config import Config

    cfg = Config()
    cfg.data.video_frames_per_window = FRAMES
    cfg.data.video_resize = (SIZE, SIZE)
    cfg.model.video_backbone = "resnet18"
    cfg.model.num_classes = 5
    cfg.model.compute_dtype = "float32"
    return cfg


def seed_inputs(seed: int):
    """The seed's IMU windows ``(4, 250, 6)`` f32 and clips ``(4, 4, 32, 32, 3)`` uint8,
    drawn as the JAX script draws them."""
    rng = np.random.default_rng(seed)
    imu = rng.normal(0, 8000, size=(BATCH, 250, 6)).astype(np.float32)
    video = (rng.random((BATCH, FRAMES, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    return imu, video


def drift_stats(base: np.ndarray, res: np.ndarray) -> dict:
    """The correlation and relative RMS drift of the resident logits from the baseline's."""
    base, res = np.asarray(base, np.float64), np.asarray(res, np.float64)
    corr = float(np.corrcoef(res.ravel(), base.ravel())[0, 1])
    spread = float(np.sqrt(np.mean((base - base.mean()) ** 2)))
    rel = float(np.sqrt(np.mean((res - base) ** 2)) / max(spread, 1e-12))
    return {"corr": corr, "rel_rms_drift": rel}


def seed_row(variables, seed: int, *, device, config=None) -> dict:
    """One seed's row over the flax-layout ``variables``: both int8 engines at batch 4 on
    ``device``, calibrated on the seed's first two clips."""
    from ..serving import InferenceEngine

    cfg = config or drift_config()
    imu, video = seed_inputs(seed)
    kw = dict(batch_sizes=[BATCH], quantize_calib_clips=video[:2], device=device)
    logits = [
        InferenceEngine(cfg, variables, quantize_resident=resident, **kw).predict(imu, video)["logits"]
        for resident in (False, True)
    ]
    return {"seed": seed, **drift_stats(*logits)}


def summary(rows: list) -> dict:
    """The JAX script's JSON over the per-seed rows."""
    corrs = np.array([r["corr"] for r in rows])
    rels = np.array([r["rel_rms_drift"] for r in rows])
    return {
        "n_seeds": len(rows),
        "corr": {"min": float(corrs.min()), "median": float(np.median(corrs))},
        "rel_rms_drift": {"min": float(rels.min()), "median": float(np.median(rels)), "max": float(rels.max())},
        "rows": rows,
    }


def run(n_seeds: int = 12, *, device) -> dict:
    from ..bridge import init_params
    from ..models.crossmodal import FusionClassifier

    cfg = drift_config()
    rows = []
    for seed in range(n_seeds):
        variables = init_params(cfg, torch.Generator().manual_seed(seed), FusionClassifier)
        rows.append(seed_row(variables, seed, device=device, config=cfg))
        log(f"seed {seed}: corr={rows[-1]['corr']:.6f} rel={rows[-1]['rel_rms_drift']:.5f}")
    out = summary(rows)
    print(json.dumps(out, indent=1))
    return out


def main(argv=None):
    args = parse_args(argv)
    return run(args.n_seeds, device=script_device(args.cpu))


if __name__ == "__main__":
    main()
