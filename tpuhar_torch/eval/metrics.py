"""Classification metrics from a confusion matrix kept on the device, and the
threshold-free AUROC (``tpuhar/eval/metrics.py``), copied so that the port imports
nothing of the JAX package.

Each predict step scatters into a ``(C, C)`` f32 confusion matrix (rows true, columns
predicted) on the device; the matrix crosses to the host once, and the metrics follow
sklearn's semantics (present-class handling included), as percentages (×100).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_METRICS = ("accuracy", "balanced_accuracy", "f1_macro", "f1_weighted", "precision_macro", "recall_macro")


def init_confusion(num_classes: int, device="cpu") -> torch.Tensor:
    return torch.zeros((num_classes, num_classes), dtype=torch.float32, device=device)


def confusion_update(cm: torch.Tensor, labels, preds, valid) -> torch.Tensor:
    """``cm`` with one batch added: each valid row adds 1 at ``[label, pred]``."""
    labels, preds, valid = (torch.as_tensor(t, device=cm.device) for t in (labels, preds, valid))
    return cm.index_put((labels.long(), preds.long()), valid.to(cm.dtype), accumulate=True)


def metrics_from_confusion(cm) -> Dict[str, float]:
    """sklearn's metrics from a confusion matrix, ×100:

    - accuracy: trace / total;
    - balanced_accuracy: the mean recall over the classes present in y_true
      (``balanced_accuracy_score``);
    - f1_macro, precision_macro, recall_macro: averaged over the classes present in
      y_true ∪ y_pred, an absent class's score 0 (``f1_score(average="macro")``);
    - f1_weighted: the support-weighted F1.
    """
    if isinstance(cm, torch.Tensor):
        cm = cm.detach().cpu().numpy()
    cm = np.asarray(cm, dtype=np.float64)
    total = cm.sum()
    if total == 0:
        return {k: 0.0 for k in _METRICS}
    tp = np.diag(cm)
    support = cm.sum(axis=1)  # true counts
    predicted = cm.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        recall = np.where(support > 0, tp / support, 0.0)
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        f1 = np.where((precision + recall) > 0, 2 * precision * recall / (precision + recall), 0.0)
    present_true = support > 0
    present_any = (support > 0) | (predicted > 0)
    n_any = max(present_any.sum(), 1)
    values = (
        tp.sum() / total,
        recall[present_true].mean() if present_true.any() else 0.0,
        f1[present_any].sum() / n_any,
        (f1 * support).sum() / support.sum() if support.sum() > 0 else 0.0,
        precision[present_any].sum() / n_any,
        recall[present_any].sum() / n_any,
    )
    return {k: 100.0 * float(v) for k, v in zip(_METRICS, values)}


def auroc(scores, labels) -> float:
    """Threshold-free AUROC via the rank statistic (Mann-Whitney U).

    ``labels`` are binary (1 = positive class); ties get averaged ranks, matching
    ``sklearn.metrics.roc_auc_score``.
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    n_pos = labels.sum()
    n_neg = (~labels).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, len(scores) + 1, dtype=np.float64)
    # average ranks for ties
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))
