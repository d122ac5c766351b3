"""The training loops (``tpuhar/train/loop.py``): epochs over any iterable of dict
batches, early stopping, checkpoints, history and the metric stream.

``CrossModalTrainer.fit``: best = the lowest validation loss, early stop after
``patience`` epochs without an improvement of more than ``min_delta``; every epoch
writes ``last``, an improvement ``best_model`` (with ``save_best_only``), and every
``save_every`` epochs ``checkpoint_epoch_N``; ``training_history.json`` at the end.

``ClassificationTrainer.fit``: best = the highest validation balanced accuracy, early
stop after ``patience`` epochs without a higher one; every epoch writes ``last``, an
improvement ``best_model``. Validation accumulates a confusion matrix on the device
(``eval.metrics``) and reads it once.

``fit(resume=True)`` restores ``last`` and continues from the epoch after it. Losses
stay on the device through an epoch and are read once at its end. Each epoch's metrics
go to ``MetricsLogger`` rows in ``paths.logs_dir``, one stream per save directory.

With ``mesh`` (``parallel.mesh``) every rank runs the loop over the same global batches:
each batch is placed on the mesh (``shard_batch``: this rank's rows) before the step, a
resumed state takes its shard of the whole checkpoint and is broadcast from rank 0
(``shard_state``), the validation metric that
decides improvement and early stopping is rank 0's on every rank, and rank 0 alone
writes checkpoints, history, metric rows and log lines (the others wait for its
checkpoints at a barrier).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..eval.metrics import confusion_update, init_confusion, metrics_from_confusion
from ..parallel.mesh import agree, is_main
from ..utils.profiling import MetricsLogger
from . import checkpoint as ckpt
from .steps import TrainState


class EarlyStopper:
    """Patience-based early stopping; ``mode`` in {"min", "max"}; ``min_delta`` is the
    least change that counts as an improvement."""

    def __init__(self, patience: int, mode: str = "min", min_delta: float = 0.0):
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.counter = 0

    def update(self, value: float) -> bool:
        """Returns True if ``value`` is a new best."""
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best - self.min_delta)
            or (self.mode == "max" and value > self.best + self.min_delta)
        )
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
        return improved

    @property
    def should_stop(self) -> bool:
        return self.counter >= self.patience


class BaseTrainer:
    """Checkpoint, history and metric-stream plumbing. ``generator`` (a
    ``torch.Generator`` on the model's device, seeded alike on every rank) feeds every
    train step's dropout and augmentation. ``metrics_logger`` writes to
    ``<paths.logs_dir>/<save_dir name>.jsonl`` and ``.csv`` (None where that directory
    cannot be made, and on every rank but 0 of a ``mesh``)."""

    def __init__(self, config, state: TrainState, save_dir, generator: Optional[torch.Generator] = None,
                 mesh=None):
        self.config = config
        self.state = state
        self.mesh = mesh
        self.save_dir = Path(save_dir)
        self.generator = generator
        self.current_epoch = 0
        self.history: Dict[str, list] = {"train": [], "val": []}
        self.verbose = is_main(mesh)
        self.metrics_logger = None
        if is_main(mesh):
            try:
                self.metrics_logger = MetricsLogger(Path(config.paths.logs_dir), name=self.save_dir.name)
            except OSError:
                pass

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    def _shard(self, batch):
        """``batch`` placed on the mesh (this rank's rows), or as it is without one."""
        if self.mesh is None:
            return batch
        from ..parallel.mesh import shard_batch

        return shard_batch(batch, self.mesh)

    def _save(self, name: str, best_key: str, best_value: float) -> None:
        ckpt.save_checkpoint(
            self.save_dir / name,
            self.state,
            extra={"epoch": self.current_epoch, "history": self.history, best_key: best_value},
            mesh=self.mesh,
        )

    def resume(self, name: str = "last") -> bool:
        """Restore state, epoch and history from a checkpoint; returns True if found."""
        path = self.save_dir / name
        if not ckpt.checkpoint_exists(path):
            return False
        self.state, extra = ckpt.restore_checkpoint(path, self.state)
        if self.mesh is not None:
            from ..parallel.mesh import shard_state

            self.state = shard_state(self.state, self.mesh)
        self.current_epoch = int(extra.get("epoch", 0)) + 1
        self.history = extra.get("history", {"train": [], "val": []})
        return True

    def _dump_history(self) -> None:
        if not is_main(self.mesh):
            return
        self.save_dir.mkdir(parents=True, exist_ok=True)
        with open(self.save_dir / "training_history.json", "w") as f:
            json.dump(self.history, f, indent=2)


class CrossModalTrainer(BaseTrainer):
    """The contrastive pretraining loop."""

    def __init__(self, config, state, train_step, eval_step, save_dir, generator=None, mesh=None):
        super().__init__(config, state, save_dir, generator, mesh)
        self.train_step = train_step
        self.eval_step = eval_step
        self.best_val_loss = float("inf")

    @property
    def best_metric(self) -> float:
        return self.best_val_loss

    def train_epoch(self, loader) -> float:
        losses = []
        for batch in loader:
            self.state, metrics = self.train_step(self.state, self._shard(batch), self.generator)
            losses.append(metrics["loss"])
        return float(np.mean(torch.stack(losses).float().cpu().numpy())) if losses else 0.0

    def validate(self, loader) -> float:
        """Validation loss, each batch weighted by its valid rows (padded rows are masked
        inside ``eval_step``, so a short final batch does not count as a full one)."""
        losses, weights = [], []
        for batch in loader:
            out = self.eval_step(self.state, self._shard(batch))
            losses.append(out["loss"])
            weights.append(float(out["n_valid"]))
        if not losses:
            return 0.0
        losses = torch.stack(losses).double().cpu().numpy()
        weights = np.asarray(weights, np.float64)
        return float(np.sum(losses * weights) / max(np.sum(weights), 1.0))

    def fit(self, train_loader, val_loader, *, resume: bool = False) -> TrainState:
        t = self.config.training
        if resume:
            self.resume()
        stopper = EarlyStopper(int(t.patience), "min", float(t.min_delta))
        stopper.best = self.best_val_loss if self.best_val_loss < float("inf") else None

        for epoch in range(self.current_epoch, int(t.pretrain_epochs)):
            self.current_epoch = epoch
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            t0 = time.perf_counter()
            train_loss = self.train_epoch(train_loader)
            val_loss = agree(self.validate(val_loader), self.mesh)
            dt = time.perf_counter() - t0
            self.history["train"].append(train_loss)
            self.history["val"].append(val_loss)
            if self.metrics_logger:
                self.metrics_logger.log(epoch, {"train_loss": train_loss, "val_loss": val_loss}, stage="pretrain")
            self._log(
                f"[Pretrain] epoch={epoch} train_loss={train_loss:.4f} "
                f"val_loss={val_loss:.4f} ({dt:.1f}s)"
            )

            improved = stopper.update(val_loss)
            if improved:
                self.best_val_loss = val_loss
            self._save("last", "best_val_loss", self.best_val_loss)
            if improved and bool(t.save_best_only):
                self._save("best_model", "best_val_loss", self.best_val_loss)
            if (epoch + 1) % int(t.save_every) == 0:
                self._save(f"checkpoint_epoch_{epoch}", "best_val_loss", self.best_val_loss)
            if stopper.should_stop:
                self._log(f"[Pretrain] Early stopping at epoch {epoch}")
                break

        self._dump_history()
        return self.state


class ClassificationTrainer(BaseTrainer):
    """The classification loop of the IMU, video or fusion classifier; ``mode``
    ("linear_probe" or "finetune") names its log lines and metric rows."""

    def __init__(self, config, state, train_step, predict_step, save_dir, generator, mode: str, mesh=None):
        super().__init__(config, state, save_dir, generator, mesh)
        if mode not in ("linear_probe", "finetune"):
            raise ValueError(f"Unknown classification mode: {mode}")
        self.mode = mode
        self.train_step = train_step
        self.predict_step = predict_step
        self.best_bal_acc = 0.0
        self.num_classes = config.model.num_classes

    @property
    def best_metric(self) -> float:
        return self.best_bal_acc

    def train_epoch(self, loader) -> Dict[str, float]:
        losses, accs = [], []
        for batch in loader:
            self.state, m = self.train_step(self.state, self._shard(batch), self.generator)
            losses.append(m["loss"])
            accs.append(m["accuracy"])
        if not losses:
            return {"loss": 0.0, "accuracy": 0.0}
        return {
            "loss": float(np.mean(torch.stack(losses).float().cpu().numpy())),
            "accuracy": float(np.mean(torch.stack(accs).float().cpu().numpy())),
        }

    def validate(self, loader) -> Dict[str, float]:
        """sklearn's metrics of the valid rows (``metrics_from_confusion``) and the mean
        cross-entropy over them, ``loss``."""
        device = next(self.state.model.parameters()).device
        cm = init_confusion(self.num_classes, device=device)
        loss_sum = torch.zeros((), dtype=torch.float64, device=device)
        n = 0
        for batch in loader:
            out = self.predict_step(self.state, self._shard(batch))  # global outputs
            cm = confusion_update(cm, batch["label"], out["preds"], out["valid"])
            loss_sum = loss_sum + out["loss_sum"].double()
            n += int(batch["n_valid"])
        metrics = metrics_from_confusion(cm)
        metrics["loss"] = loss_sum.item() / max(n, 1)
        return metrics

    def fit(self, train_loader, val_loader, *, resume: bool = False) -> TrainState:
        t = self.config.training
        if resume:
            self.resume()
        stopper = EarlyStopper(int(t.patience), "max")
        stopper.best = self.best_bal_acc if self.best_bal_acc > 0 else None

        for epoch in range(self.current_epoch, int(t.train_epochs)):
            self.current_epoch = epoch
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            train_metrics = self.train_epoch(train_loader)
            val_metrics = self.validate(val_loader)
            self.history["train"].append(train_metrics)
            self.history["val"].append(val_metrics)
            if self.metrics_logger:
                self.metrics_logger.log(
                    epoch,
                    {**{f"train_{k}": v for k, v in train_metrics.items()},
                     **{f"val_{k}": v for k, v in val_metrics.items()}},
                    stage=f"classify_{self.mode}",
                )
            self._log(
                f"[Cls:{self.mode}] epoch={epoch} "
                f"train_loss={train_metrics['loss']:.4f} "
                f"train_acc={train_metrics['accuracy']:.2f}% | "
                f"val_loss={val_metrics['loss']:.4f} "
                f"val_bal_acc={val_metrics['balanced_accuracy']:.2f}% "
                f"val_f1={val_metrics['f1_macro']:.2f}%"
            )

            bal_acc = float(agree(val_metrics["balanced_accuracy"], self.mesh))
            improved = stopper.update(bal_acc)
            if improved:
                self.best_bal_acc = bal_acc
            self._save("last", "best_balanced_accuracy", self.best_bal_acc)
            if improved:
                self._save("best_model", "best_balanced_accuracy", self.best_bal_acc)
            if stopper.should_stop:
                self._log(f"[Cls:{self.mode}] Early stopping at epoch {epoch}")
                break

        self._dump_history()
        return self.state
