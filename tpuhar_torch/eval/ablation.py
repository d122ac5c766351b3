"""The ablation harness (``tpuhar/eval/ablation.py``): a grid of configuration variants,
each a set of dotted overrides on a base configuration, each training an IMU classifier
from scratch (the finetune recipe) and reporting its test metrics, the rows of
``ablation_results.csv`` that Table 5 reads.

The default grid covers the IMU encoder and featurizer: the raw-patch transformer, the
STFT transformer, the 1-D CNN, quirk Q1's positional truncation and the windows without
per-window normalization. ``data.*`` overrides act on the model's side (the STFT is
computed inside the encoder); the preprocessed windows are shared.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ..data.loader import BatchLoader
from ..train.factory import default_generator
from .evaluator import Evaluator, restore_best, train_classifier

DEFAULT_ABLATIONS: List[Tuple[str, Dict[str, object]]] = [
    ("transformer_raw", {}),
    ("transformer_stft", {"data.imu_featurizer": "stft"}),
    ("cnn_raw", {"model.imu_encoder": "cnn"}),
    ("transformer_raw_q1_truncation", {"model.replicate_pos_truncation": True}),
    ("no_normalization", {"data.normalize_imu": False}),
]


def _apply_overrides(config, overrides: Dict[str, object]):
    """A deep copy of ``config`` with each ``"section.key": value`` set."""
    cfg = copy.deepcopy(config)
    for dotted, value in overrides.items():
        section, key = dotted.split(".", 1)
        setattr(getattr(cfg, section), key, value)
    return cfg


def run_ablations(config, train_df, val_df, test_df, ablations: Optional[List[Tuple[str, Dict[str, object]]]] = None,
                  generator: Optional[torch.Generator] = None, verbose: bool = True, *, device):
    """Each variant trained on ``train_df`` (selected on ``val_df``, its best epoch
    restored) and evaluated on ``test_df``; one row per variant: ``config`` and the
    metrics."""
    import pandas as pd

    generator = default_generator(config, generator)
    rows = []
    for name, overrides in ablations or DEFAULT_ABLATIONS:
        cfg = _apply_overrides(config, overrides)
        bs = min(cfg.training.train_batch_size, max(len(train_df), 1))
        loader = lambda df, **kw: BatchLoader(df, cfg, mode="classification", prefetch=0, device=device, **kw)  # noqa: E731
        task, trainer = train_classifier(
            cfg, "finetune", max(len(train_df) // bs, 1),
            loader(train_df, batch_size=bs, shuffle=True, drop_last=True, seed=cfg.training.seed), loader(val_df),
            Path(cfg.paths.checkpoints_dir) / f"ablation_{name}", generator=generator, device=device,
        )
        restore_best(task, trainer)
        metrics = Evaluator(task, cfg).evaluate(loader(test_df))["metrics"]
        rows.append({"config": name, **metrics})
        if verbose:
            print(f"[Ablation] {name}: bal_acc={metrics['balanced_accuracy']:.2f}", flush=True)
    return pd.DataFrame(rows)
