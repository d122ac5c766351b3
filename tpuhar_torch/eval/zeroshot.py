"""Zero-shot IMU classification in the cross-modal embedding space
(``tpuhar/eval/zeroshot.py``): after SigLIP pretraining, the train split's clips of each
class give its prototype (the renormalized mean of their unit video projections), and
the test split's IMU windows are classified by the nearest prototype; no label reaches
the IMU tower. ``run_zero_shot`` writes the ``zeroshot_results.json`` that Table 4
reads.

The cores take batches on the model's device: ``class_prototypes`` clips with labels
(``{"video", "label", "n_valid"}``), ``zero_shot_metrics`` IMU windows with labels. The
prototypes' sums are kept on the device in float64 and read once. The JAX package runs
the whole model for either projection (a zero IMU window beside each clip, an
un-normalized zero clip beside each window); each projection depends on its own tower
only, so the port runs that tower and its projection (``CrossModalModel(imu=None)``,
``(video=None)``): the same outputs for less work.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..data.loader import BatchLoader
from ..models.layers import l2_normalize
from ..ops.video import normalize_clip
from ..ood import full_f32
from ..train.steps import _precision, precision_scope
from .metrics import confusion_update, init_confusion, metrics_from_confusion


@torch.no_grad()
def class_prototypes(task, batches: Iterable, config) -> torch.Tensor:
    """``(num_classes, projection_dim)`` f32 on the device: per class the mean of its
    clips' unit video projections, renormalized (a class without clips stays 0)."""
    model = task.state.model
    device = next(model.parameters()).device
    C, D = config.model.num_classes, config.model.projection_dim
    sums = torch.zeros((C, D), dtype=torch.float64, device=device)
    counts = torch.zeros((C,), dtype=torch.float64, device=device)
    with precision_scope(_precision(config)):
        for batch in batches:
            n = int(batch["n_valid"])
            proj = model.forward_cast(None, normalize_clip(batch["video"]), train=False)["video_proj"][:n]
            labels = batch["label"][:n].long()
            sums.index_add_(0, labels, proj.double())
            counts.index_add_(0, labels, torch.ones_like(labels, dtype=torch.float64))
    protos = sums / torch.clamp(counts[:, None], min=1)
    protos = protos / torch.clamp(torch.linalg.vector_norm(protos, dim=1, keepdim=True), min=1e-12)
    return protos.float()


@torch.no_grad()
def zero_shot_metrics(task, prototypes: torch.Tensor, batches: Iterable, config) -> Dict[str, float]:
    """sklearn-semantics metrics of nearest-prototype classification of the batches'
    IMU windows (``{"imu", "label", "n_valid"}``)."""
    model = task.state.model
    device = next(model.parameters()).device
    protos = torch.as_tensor(prototypes, device=device).float()
    cm = init_confusion(config.model.num_classes, device=device)
    with precision_scope(_precision(config)):
        for batch in batches:
            imu_proj = model.forward_cast(batch["imu"], None, train=False)["imu_proj"]
            with full_f32():
                sims = l2_normalize(imu_proj) @ protos.T
            preds = torch.argmax(sims, dim=-1)
            valid = torch.arange(preds.shape[0], device=device) < int(batch["n_valid"])
            cm = confusion_update(cm, batch["label"], preds, valid)
    return metrics_from_confusion(cm)


def compute_class_prototypes(task, train_df, config) -> np.ndarray:
    """The prototypes of ``train_df``'s clips (batches of ``pretrain_batch_size``), as
    numpy."""
    device = next(task.state.model.parameters()).device
    loader = BatchLoader(train_df, config, mode="fusion", batch_size=config.training.pretrain_batch_size, device=device)
    return class_prototypes(task, loader, config).cpu().numpy()


def zero_shot_evaluate(task, prototypes, test_df, config) -> Dict[str, float]:
    """The metrics of ``test_df``'s IMU windows classified by nearest prototype."""
    device = next(task.state.model.parameters()).device
    return zero_shot_metrics(task, prototypes, BatchLoader(test_df, config, mode="classification", device=device), config)


def run_zero_shot(task, train_df, test_df, config, save_path: Optional[Path] = None) -> Dict[str, Dict[str, float]]:
    """Prototypes from ``train_df``, metrics on ``test_df``; writes them to
    ``save_path`` (``zeroshot_results.json``) when given."""
    protos = compute_class_prototypes(task, train_df, config)
    results = {"video_prototype_zeroshot": zero_shot_evaluate(task, protos, test_df, config)}
    if save_path is not None:
        Path(save_path).write_text(json.dumps(results, indent=2))
    return results
