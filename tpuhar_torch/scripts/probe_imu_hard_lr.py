"""Can supervised IMU classification learn the hard fixture at all, and at which
learning rate? (``scripts/probe_imu_hard_lr.py``)

On the article work directory's preprocessed splits, the IMU classifier is finetuned
from a random encoder at each learning rate (encoder and head alike) for ``epochs``
epochs, with no early stop, through the classification task, ``ClassificationTrainer``
and ``Evaluator``. Per rate it prints the last five epochs' train accuracy and val
balanced accuracy (``training_history.json``) and the last state's test balanced
accuracy.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.probe_imu_hard_lr [epochs=25] [--cpu]``
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ._common import log, script_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("epochs", nargs="?", type=int, default=25)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def run(epochs: int = 25, *, device, work="outputs/torch/article_hard", lrs=(3e-3, 1e-3, 3e-4, 1e-4),
        out_root="outputs/torch/probe_lr") -> dict:
    import pandas as pd

    from ..bridge import init_params
    from ..data.loader import create_dataloaders
    from ..data.synthetic import make_synthetic_config
    from ..eval.evaluator import Evaluator
    from ..models.crossmodal import IMUClassifier
    from ..train.factory import build_classification_task
    from ..train.loop import ClassificationTrainer

    work = Path(work)
    cfg = make_synthetic_config(
        work / "data", work / "out", num_classes=6,
        video_backbone="tpu_cnn", video_resize=(64, 64),
        train_epochs=epochs, train_batch_size=32,
    )
    cfg.data.video_frames_per_window = 4
    cfg.model.compute_dtype = "float32"
    cfg.model.head_norm = "layer"
    cfg.training.patience = epochs + 1
    dfs = tuple(pd.read_csv(work / "out" / "preprocessed" / f"{s}_metadata.csv") for s in ("train", "val", "test"))

    results = {}
    for mode in ("finetune",):
        for lr in lrs:
            cfg.training.train_lr_encoder = lr
            cfg.training.train_lr_head = lr
            loaders = create_dataloaders(cfg, *dfs, mode="classification", device=device)
            task = build_classification_task(
                cfg, mode, max(len(loaders["train"]), 1),
                init_params(cfg, torch.Generator().manual_seed(0), IMUClassifier), device=device,
            )
            tr = ClassificationTrainer(
                cfg, task.state, task.train_step, task.eval_step, Path(out_root) / f"{mode}_{lr:.0e}",
                torch.Generator(device=device).manual_seed(0), mode,
            )
            tr.verbose = False
            task.state = tr.fit(loaders["train"], loaders["val"])
            hist = json.loads((tr.save_dir / "training_history.json").read_text())
            tacc = [round(e["accuracy"], 1) for e in hist["train"]]
            vacc = [round(e.get("balanced_accuracy", e["accuracy"]), 1) for e in hist["val"]]
            m = Evaluator(task, cfg).evaluate(loaders["test"])["metrics"]
            row = results[f"{mode}/{lr:.0e}"] = {
                "train_acc_last5": tacc[-5:], "val_bal_last5": vacc[-5:],
                "test_bal": round(float(m["balanced_accuracy"]), 2),
            }
            log(f"{mode} lr={lr:.0e}: train tail {tacc[-5:]} val tail {vacc[-5:]} test {row['test_bal']}")
    print(json.dumps(results, indent=1))
    return results


def main(argv=None):
    args = parse_args(argv)
    return run(args.epochs, device=script_device(args.cpu))


if __name__ == "__main__":
    main()
