"""Evaluation (``tpuhar/eval/evaluator.py``): batched inference with metric reports,
the few-shot grid run by run, and the scratch-versus-pretrained comparison.

- ``Evaluator``: the predictions, labels, logits and embeddings of a task's
  ``eval_step`` over a loader (the valid rows of each batch gathered on the device and
  copied to the host in one transfer), sklearn-semantics metrics through the device
  confusion matrix of ``eval.metrics``, and the logits' calibration.
- ``FewShotEvaluator``: the grid ``eval.few_shot_samples`` × ``few_shot_runs`` ×
  ``eval_modes``, each run one trainer: samples seeded ``run + 42``, train batch 32 and
  eval batch 64, the best epoch's checkpoint evaluated on the test set; it fits on the
  test set when ``eval.replicate_test_as_val`` is set or no validation split is given
  (quirk Q4). Every run starts from the same pretrained tree (quirk Q5 not replicated).
- ``compare_baseline_vs_pretrained`` and ``save_results_table``.

Each task is built from a tree drawn with ``bridge.init_params`` from a
``torch.Generator`` (default seeded ``training.seed``), split per task into an init
and a fit generator (``train.factory.task_generators``) as the JAX package splits its
key. The DataFrame entries build ``data.loader.BatchLoader``s on ``device``; the cores
(``Evaluator``, ``train_classifier``) take any iterable of batches.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..bridge import init_params
from ..data.loader import BatchLoader
from ..data.manifest import FewShotSampler
from ..models.crossmodal import IMUClassifier
from ..train import checkpoint as ckpt
from ..train.factory import build_classification_task, default_generator, task_generators
from ..train.loop import ClassificationTrainer
from .calibration import expected_calibration_error
from .fewshot_parallel import EVAL_BS, TRAIN_BS
from .metrics import confusion_update, init_confusion, metrics_from_confusion


class Evaluator:
    """Batched evaluation of a classification task (``train.factory.Task``)."""

    def __init__(self, task, config):
        self.task = task
        self.config = config

    def predict(self, loader):
        """``(predictions, labels, logits, embeddings)`` of the valid rows, numpy
        (int32, int32, f32, f32), over batches on the model's device
        (``BatchLoader(device=...)``)."""
        rows = []
        width = None
        for batch in loader:
            out = self.task.eval_step(self.task.state, batch)
            logits, emb = out["logits"].float(), out["embeddings"].float()
            width = (logits.shape[1], emb.shape[1])
            packed = torch.cat([logits, emb, out["preds"][:, None].float(), batch["label"][:, None].float()], dim=1)
            rows.append(packed[out["valid"]].cpu().numpy())
        C = self.config.model.num_classes
        if not rows:
            return np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, C), np.float32), np.zeros((0, 0), np.float32)
        rows = np.concatenate(rows)
        c, e = width
        return (rows[:, c + e].astype(np.int32), rows[:, c + e + 1].astype(np.int32),
                np.ascontiguousarray(rows[:, :c]), np.ascontiguousarray(rows[:, c:c + e]))

    def compute_metrics(self, y_true, y_pred) -> Dict[str, float]:
        cm = init_confusion(self.config.model.num_classes)
        y_true, y_pred = torch.as_tensor(np.asarray(y_true)), torch.as_tensor(np.asarray(y_pred))
        return metrics_from_confusion(confusion_update(cm, y_true, y_pred, torch.ones(len(y_true), dtype=torch.bool)))

    def evaluate(self, loader) -> Dict:
        preds, labels, logits, embs = self.predict(loader)
        return {
            "metrics": self.compute_metrics(labels, preds),
            "predictions": preds,
            "labels": labels,
            "logits": logits,
            "embeddings": embs,
            "calibration": expected_calibration_error(logits, labels),
        }

    def generate_classification_report(self, y_true, y_pred, class_names=None):
        import pandas as pd
        from sklearn.metrics import classification_report

        C = self.config.model.num_classes
        report = classification_report(
            y_true, y_pred, labels=list(range(C)), target_names=class_names or [str(i) for i in range(C)],
            output_dict=True, zero_division=0,
        )
        return pd.DataFrame(report).transpose()

    def plot_confusion_matrix(self, y_true, y_pred, class_names=None, save_path=None):
        """Draw the confusion matrix (``report.plots``, matplotlib); returns its counts."""
        from ..report.plots import plot_confusion_matrix

        return plot_confusion_matrix(y_true, y_pred, self.config.model.num_classes, class_names, save_path)


def train_classifier(config, mode: str, steps_per_epoch: int, train_loader, val_loader, save_dir, *,
                     generator: torch.Generator, device, encoder_params: Optional[Mapping] = None,
                     verbose: bool = False):
    """An IMU classifier in ``mode`` drawn from ``generator``'s init generator (its
    encoder replaced by ``encoder_params`` when given) and fitted by a
    ``ClassificationTrainer`` with its fit generator; returns ``(task, trainer)``."""
    init_gen, fit_gen = task_generators(generator, device)
    task = build_classification_task(config, mode, steps_per_epoch, init_params(config, init_gen, IMUClassifier),
                                     encoder_params=encoder_params, device=device)
    trainer = ClassificationTrainer(config, task.state, task.train_step, task.eval_step, save_dir, fit_gen, mode)
    trainer.verbose = verbose
    task.state = trainer.fit(train_loader, val_loader)
    return task, trainer


def restore_best(task, trainer) -> None:
    """``task``'s state from the trainer's ``best_model`` checkpoint, where one exists."""
    best = trainer.save_dir / "best_model"
    if ckpt.checkpoint_exists(best):
        task.state, _ = ckpt.restore_checkpoint(best, task.state)


class FewShotEvaluator:
    """The few-shot grid run by run (``run_parallel_fewshot`` batches each cell's runs)."""

    def __init__(self, config, generator: Optional[torch.Generator] = None, *, device):
        self.config = config
        self.generator = default_generator(config, generator)
        self.device = device

    def run_few_shot_experiments(self, pretrained_encoder_params, train_df, test_df, val_df=None,
                                 experiment_name: str = "default", verbose: bool = True):
        """The grid's raw results: one row per (n_samples, run, mode) with the metrics."""
        import pandas as pd

        e = self.config.eval
        fit_val_df = test_df if (e.replicate_test_as_val or val_df is None) else val_df
        results = []
        for n_samples in e.few_shot_samples:
            for run in range(e.few_shot_runs):
                subset = FewShotSampler(train_df, self.config).sample_k_per_class(n_samples, seed=run + 42)
                for mode in e.eval_modes:
                    metrics = self._train_and_eval(pretrained_encoder_params, subset, fit_val_df, test_df, mode, run)
                    results.append({"experiment": experiment_name, "n_samples": n_samples, "run": run, "mode": mode,
                                    **metrics})
                    if verbose:
                        print(f"[FewShot] {experiment_name} n={n_samples} run={run} {mode}: "
                              f"bal_acc={metrics['balanced_accuracy']:.2f}", flush=True)
        return pd.DataFrame(results)

    def _train_and_eval(self, encoder_params, train_subset, val_df, test_df, mode: str, run: int) -> Dict[str, float]:
        cfg = self.config
        train_bs = min(TRAIN_BS, max(len(train_subset), 1))
        loader = lambda df, **kw: BatchLoader(df, cfg, mode="classification", prefetch=0, device=self.device, **kw)  # noqa: E731
        task, trainer = train_classifier(
            cfg, mode, max(len(train_subset) // train_bs, 1),
            loader(train_subset, batch_size=train_bs, shuffle=True, drop_last=True, seed=run + 42),
            loader(val_df, batch_size=EVAL_BS),
            Path(cfg.paths.checkpoints_dir) / f"fewshot_{mode}_r{run}",
            generator=self.generator, device=self.device, encoder_params=encoder_params,
        )
        restore_best(task, trainer)
        return Evaluator(task, cfg).evaluate(loader(test_df, batch_size=EVAL_BS))["metrics"]

    def aggregate_results(self, results_df):
        """Mean and std of balanced accuracy, macro F1 and accuracy by (experiment,
        n_samples, mode)."""
        agg = (
            results_df.groupby(["experiment", "n_samples", "mode"])
            .agg({"balanced_accuracy": ["mean", "std"], "f1_macro": ["mean", "std"], "accuracy": ["mean", "std"]})
            .reset_index()
        )
        agg.columns = ["_".join(col).strip("_") for col in agg.columns.values]
        return agg

    def create_comparison_table(self, results_dict):
        """Rows (experiment, mode), columns n_samples, cells "mean ± std" of balanced
        accuracy."""
        import pandas as pd

        parts = []
        for name, df in results_dict.items():
            agg = self.aggregate_results(df)
            agg["experiment"] = name
            parts.append(agg)
        comparison = pd.concat(parts, ignore_index=True)
        comparison["balanced_accuracy_formatted"] = comparison.apply(
            lambda r: f"{r['balanced_accuracy_mean']:.2f} ± {r['balanced_accuracy_std']:.2f}", axis=1
        )
        return comparison.pivot_table(index=["experiment", "mode"], columns="n_samples",
                                      values="balanced_accuracy_formatted", aggfunc="first")


def compare_baseline_vs_pretrained(config, train_df, val_df, test_df, pretrained_encoder_params=None,
                                   generator: Optional[torch.Generator] = None, verbose: bool = True, *, device):
    """One finetune classifier from scratch ("baseline") and, with
    ``pretrained_encoder_params``, one from the pretrained encoder ("pretrained"), each
    fitted on ``train_df``/``val_df`` and its final state evaluated on ``test_df``;
    returns their metrics, one row each."""
    import pandas as pd

    generator = default_generator(config, generator)
    variants = {"baseline": None}
    if pretrained_encoder_params is not None:
        variants["pretrained"] = pretrained_encoder_params
    rows = {}
    for name, enc in variants.items():
        bs = config.training.train_batch_size
        task, _ = train_classifier(
            config, "finetune", max(len(train_df) // bs, 1),
            BatchLoader(train_df, config, mode="classification", shuffle=True, drop_last=True,
                        seed=config.training.seed, device=device),
            BatchLoader(val_df, config, mode="classification", device=device),
            Path(config.paths.checkpoints_dir) / f"compare_{name}",
            generator=generator, device=device, encoder_params=enc, verbose=verbose,
        )
        rows[name] = Evaluator(task, config).evaluate(
            BatchLoader(test_df, config, mode="classification", device=device))["metrics"]
    return pd.DataFrame(rows).T


def save_results_table(df, save_path, format: str = "csv") -> None:
    """A results table as CSV, LaTeX or Markdown."""
    save_path = Path(save_path)
    if format == "csv":
        df.to_csv(save_path)
    elif format == "latex":
        df.to_latex(save_path)
    elif format == "markdown":
        df.to_markdown(save_path)
    else:
        raise ValueError(f"Unknown format: {format}")
