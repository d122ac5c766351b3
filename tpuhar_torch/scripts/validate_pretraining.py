"""Validate the cross-modal learning path: pretraining must transfer
(``scripts/validate_pretraining.py``).

On the synthetic fixture (the IMU frequency and the video tint both encode the class)
this runs cross-modal pretraining (InfoNCE: SigLIP collapses at these batch sizes), then
compares a linear probe on the pretrained IMU encoder against a probe on a randomly
initialized one. Pretraining helping the probe is the reference pipeline's core claim.

Runs on the card unless ``--cpu``, in a fresh temporary directory:
``python -m tpuhar_torch.scripts.validate_pretraining [--cpu]``
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from ._common import log, script_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    from ..cli import Pipeline
    from ..data.loader import create_dataloaders
    from ..data.synthetic import generate_synthetic_dataset, make_synthetic_config
    from ..eval.evaluator import Evaluator, restore_best, train_classifier

    device = script_device(parse_args(argv).cpu)
    tmp = Path(tempfile.mkdtemp(prefix="tpuhar_pretrain_val_"))
    generate_synthetic_dataset(tmp / "data", num_classes=4, samples_per_class=6, seq_len=1200, seed=0)
    cfg = make_synthetic_config(tmp / "data", tmp / "out")
    cfg.model.imu_num_layers = 2
    cfg.model.imu_d_model = 64
    cfg.model.imu_nhead = 4
    cfg.model.compute_dtype = "float32"
    cfg.model.head_norm = "layer"
    cfg.model.video_d_model = 64
    cfg.model.projection_dim = 32
    cfg.model.projection_hidden_dim = 64
    cfg.model.classifier_hidden_dims = [32]
    cfg.model.classifier_dropout = 0.0
    cfg.data.video_frames_per_window = 4
    # InfoNCE for small-batch pretraining: SigLIP collapses to the all-negative solution
    # below some hundreds of samples per batch
    cfg.training.use_sigmoid_loss = False
    cfg.training.pretrain_epochs = 15
    cfg.training.pretrain_batch_size = 16
    cfg.training.pretrain_warmup_epochs = 2
    cfg.training.pretrain_lr = 5e-4
    cfg.training.train_epochs = 8
    cfg.training.train_batch_size = 16
    cfg.training.train_lr_head = 3e-3

    pipe = Pipeline(cfg, device=device)
    pipe.run_preprocessing()
    pipe.run_pretraining()

    train_df, val_df, test_df = pipe._metadata("train"), pipe._metadata("val"), pipe._metadata("test")
    enc_params, _ = pipe._load_pretrained_encoder()
    if enc_params is None:
        raise RuntimeError("pretraining produced no encoder checkpoint")

    results = {}
    for name, enc in (("pretrained", enc_params), ("random", None)):
        loaders = create_dataloaders(cfg, train_df, val_df, test_df, mode="classification", device=device)
        task, trainer = train_classifier(
            cfg, "linear_probe", max(len(loaders["train"]), 1), loaders["train"], loaders["val"],
            Path(cfg.paths.checkpoints_dir) / f"val_probe_{name}", generator=pipe._next_key(), device=device,
            encoder_params=enc,
        )
        restore_best(task, trainer)
        m = Evaluator(task, cfg).evaluate(loaders["test"])["metrics"]
        results[name] = m["balanced_accuracy"]
        log(f"linear probe ({name:10}): balanced acc {m['balanced_accuracy']:6.2f}")

    delta = results["pretrained"] - results["random"]
    log(f"pretraining transfer delta: {delta:+.2f} points")
    log("WARNING: pretraining did not help on this run" if delta <= 0 else "PRETRAINING TRANSFER CONFIRMED")
    return results


if __name__ == "__main__":
    main()
