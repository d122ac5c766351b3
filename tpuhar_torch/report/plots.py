"""Host-side plots (``tpuhar/report/plots.py``): training curves, confusion matrices and
an IMU window, written with matplotlib's Agg backend. matplotlib is imported by each
function, so the module imports where matplotlib is missing and a call there raises
``ImportError`` (``cli.Pipeline`` reports such a plot as not written).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, plt, save_path) -> None:
    fig.tight_layout()
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_training_curves(history: Dict[str, list], save_path=None, title: str = "Training curves"):
    """Train and val loss per epoch: a pretraining history's floats or the classifiers'
    metric dicts (their "loss")."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for split in ("train", "val"):
        values = history.get(split, [])
        if not values:
            continue
        if isinstance(values[0], dict):
            values = [v.get("loss", np.nan) for v in values]
        ax.plot(values, label=f"{split} loss")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(title)
    ax.legend()
    _save(fig, plt, save_path)


def plot_metric_curves(history: Dict[str, list], metric: str, save_path=None):
    """A named metric of a classification history (lists of dicts)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for split in ("train", "val"):
        values = [v.get(metric, np.nan) for v in history.get(split, []) if isinstance(v, dict)]
        if values:
            ax.plot(values, label=f"{split} {metric}")
    ax.set_xlabel("epoch")
    ax.set_ylabel(metric)
    ax.legend()
    _save(fig, plt, save_path)


def plot_confusion_matrix(
    y_true,
    y_pred,
    num_classes: int,
    class_names: Optional[List[str]] = None,
    save_path=None,
    title: str = "Confusion Matrix",
):
    """Draw the confusion matrix; returns its ``(num_classes, num_classes)`` int64 counts,
    rows the true class."""
    if class_names is None:
        class_names = [str(i) for i in range(num_classes)]
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    for t, p in zip(np.asarray(y_true), np.asarray(y_pred)):
        cm[int(t), int(p)] += 1
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 10))
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im, ax=ax)
    ax.set_xticks(range(num_classes), class_names, rotation=90, fontsize=7)
    ax.set_yticks(range(num_classes), class_names, fontsize=7)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title)
    _save(fig, plt, save_path)
    return cm


def visualize_imu_window(window, save_path=None, title: str = "IMU window"):
    """The 6 channels of one ``(T, C)`` or ``(C, T)`` window: accelerometer above,
    gyroscope below."""
    w = np.asarray(window)
    if w.shape[0] < w.shape[1]:  # (C, T) → (T, C)
        w = w.T
    plt = _pyplot()
    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    names = ["acc_x", "acc_y", "acc_z", "gyro_x", "gyro_y", "gyro_z"]
    for c in range(min(3, w.shape[1])):
        axes[0].plot(w[:, c], label=names[c])
    for c in range(3, min(6, w.shape[1])):
        axes[1].plot(w[:, c], label=names[c])
    axes[0].set_title(f"{title} — accelerometer")
    axes[1].set_title("gyroscope")
    for ax in axes:
        ax.legend(fontsize=8)
    _save(fig, plt, save_path)
