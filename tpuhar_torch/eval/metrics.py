"""Threshold-free AUROC (``tpuhar/eval/metrics.py: auroc``), in numpy, copied so that
the port imports nothing of the JAX package."""
from __future__ import annotations

import numpy as np


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
