"""Does a stored fusion checkpoint still fit the windows on disk?
(``scripts/debug_ckpt_data_match.py``)

Scores the ``fusion_full`` checkpoint under ``<root>/<tower>/checkpoints/`` (``last``)
against the windows and frame banks now under ``<root>/preprocessed``, and prints the
training-time last epoch from its ``training_history.json`` beside it. A checkpoint that
scores at its training-time level here says the preprocessing was byte-stable; a
collapse says the windows were regenerated differently from those it was trained on,
and that cross-run scoring compares a model against data it never saw.

Prints the accuracy over the first ``n`` test windows and the confusion matrix (rows:
the true class). The training-time tail is each split's last epoch (the JAX script's
filter finds no key in the trainers' ``{"train": [...], "val": [...]}`` history and
prints ``{}``).

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.debug_ckpt_data_match [root=outputs/torch/bench_accuracy_hard]
[tower=tpu_cnn] [n=192] [--cpu]``
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ._common import fusion_model, restore_fusion_variables, score_split, script_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?", default="outputs/torch/bench_accuracy_hard")
    p.add_argument("tower", nargs="?", default="tpu_cnn")
    p.add_argument("n", nargs="?", type=int, default=192)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def last_epoch(history) -> dict:
    """The accuracy and loss entries of each split's last epoch, as ``val_balanced_accuracy``."""
    if isinstance(history, list):
        history = {"": history}
    return {
        f"{split}_{k}" if split else k: v
        for split, rows in history.items() if rows
        for k, v in rows[-1].items() if "acc" in k or "loss" in k
    }


def confusion(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), int)
    for p, t in zip(preds, labels):
        cm[t, p] += 1
    return cm


def run(root="outputs/torch/bench_accuracy_hard", tower: str = "tpu_cnn", n: int = 192, *, device,
        num_classes: int = 6, frames: int = 16, resize: int = 224) -> dict:
    """Score the first ``n`` test windows; returns the accuracy (%), the confusion
    matrix, the training-time last epoch, and the scored rows' logits and labels."""
    import pandas as pd

    from ..data.synthetic import make_synthetic_config
    from ..ops.video import normalize_clip

    root = Path(root)
    ckpt_dir = root / tower / "checkpoints" / "fusion_full"
    cfg = make_synthetic_config(
        root / "fixture", root / tower,
        num_classes=num_classes, video_backbone=tower,
        video_resize=(resize, resize), train_epochs=4, train_batch_size=16,
    )
    cfg.data.video_frames_per_window = frames
    cfg.data.featurize_backend = "host"
    cfg.paths.preprocessed_dir = root / "preprocessed"

    tail = None
    hist = ckpt_dir / "training_history.json"
    if hist.exists():
        tail = last_epoch(json.loads(hist.read_text()))
        print(f"training-time last epoch: {tail}")

    model = fusion_model(cfg, restore_fusion_variables(cfg, ckpt_dir / "last"), device)
    df = pd.read_csv(root / "preprocessed" / "test_metadata.csv").head(n)
    logits, _, labels = score_split(df, cfg, lambda imu, video_u8: model(imu, normalize_clip(video_u8)), 16, device,
                                    labels=True)
    preds = np.argmax(logits, 1)
    acc = float((preds == labels).mean()) * 100
    print(f"current-data acc over {len(preds)}: {acc:.2f}%")
    cm = confusion(preds, labels, num_classes)
    print("confusion (rows=true):")
    print(cm)
    return {"accuracy": acc, "confusion": cm, "training_last_epoch": tail, "logits": logits, "labels": labels}


def main(argv=None):
    args = parse_args(argv)
    return run(args.root, args.tower, args.n, device=script_device(args.cpu))


if __name__ == "__main__":
    main()
