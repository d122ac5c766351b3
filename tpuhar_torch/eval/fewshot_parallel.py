"""The parallel few-shot harness (``tpuhar/eval/fewshot_parallel.py``): the R runs of a
grid cell train as one batched program.

Every run of a cell ``(n_samples, mode)`` has the same shapes (each class gives
``min(k, count)`` windows whatever the seed), so the R runs' IMU classifiers are stacked
on a leading axis and trained together: ``torch.func.vmap`` over
``torch.func.grad_and_value`` of a ``torch.func.functional_call`` of one classifier,
with the parameters (f32 masters, cast at use to the dtype the model was built in) and
the buffers (the BatchNorm running statistics, updated in place run by run) stacked
(``BatchedRuns``). Dropout draws different masks per run (``randomness="different"``).
The optimizer (``BatchedAdamW``) is the port's ``train.optim.AdamW`` on the stacked
tensors: each run's gradient is clipped by its own global norm, over its own slice of
every leaf, then every elementwise step is the sequential one. Evaluation shares each
batch across the runs.

Kept from the JAX package: the sampling seeds ``run + 42``, train batch 32 and eval
batch 64, each run's batch order ``default_rng((run + 42)·1000 + epoch)``, best-epoch
selection by balanced accuracy with early stopping per run (``PerRunEarlyStopper``: a
stopped run keeps stepping, its results masked out; the loop ends when every run has
stopped), the best epoch's parameters kept on the device by a masked selection, and the
final test evaluation of those parameters with the running statistics of the last step
(the JAX harness keeps only the parameters of the best epoch).

The DataFrame entry (``run_parallel_fewshot``) reads the window banks and draws the
runs' samples, then hands arrays to ``fewshot_rows``, which needs no pandas.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import losses as L
from ..bridge import init_params
from ..data.loader import load_imu_window
from ..data.manifest import FewShotSampler
from ..models.crossmodal import IMUClassifier
from ..train.factory import _graft_encoder, _masters, default_generator, split_seeds
from ..train.optim import B1, B2, EPS, classification_groups, classification_schedule
from ..train.steps import _precision, precision_scope
from .metrics import metrics_from_confusion

TRAIN_BS, EVAL_BS = 32, 64  # the JAX package's (and its reference's) few-shot batch sizes


class PerRunEarlyStopper:
    """Max-mode early stopping with one patience counter per run: ``train.loop.
    EarlyStopper(patience, "max")`` run by run, a run's values ignored once it stopped."""

    def __init__(self, runs: int, patience: int):
        self.patience = int(patience)
        self.best = np.full((runs,), -np.inf)
        self.counters = np.zeros((runs,), np.int64)
        self.active = np.ones((runs,), bool)

    def update(self, values) -> np.ndarray:
        """One epoch's metric per run; returns the runs that are active and improved
        (only these may keep their parameters as the best)."""
        values = np.asarray(values, np.float64)
        improved = (values > self.best) & self.active
        self.best = np.where(improved, values, self.best)
        self.counters = np.where(improved, 0, self.counters + self.active)
        self.active &= self.counters < self.patience
        return improved

    @property
    def all_stopped(self) -> bool:
        return not self.active.any()


def load_window_bank(df, config) -> np.ndarray:
    """Every window of a manifest as one ``(N, C, T)`` array: one gather from the packed
    ``{split}_windows.npy`` banks where the manifest has ``bank_idx``, else one file per
    window."""
    d = config.data
    df = df.reset_index(drop=True)
    if "bank_idx" in df.columns and "split" in df.columns:
        try:
            parts = []
            for split, sub in df.groupby("split", sort=False):
                packed = np.load(Path(config.paths.preprocessed_dir) / f"{split}_windows.npy", mmap_mode="r")
                parts.append((sub.index.to_numpy(), packed[sub["bank_idx"].to_numpy()]))
            bank = np.zeros((len(df), d.imu_window_size, d.imu_channels), np.float32)
            for idx, rows in parts:
                bank[idx] = rows
            return np.ascontiguousarray(bank.transpose(0, 2, 1))
        except (FileNotFoundError, IndexError, ValueError):
            pass
    bank = np.zeros((len(df), d.imu_channels, d.imu_window_size), np.float32)
    for i, (_, row) in enumerate(df.iterrows()):
        bank[i] = load_imu_window(row["imu_window_path"], config.paths.preprocessed_dir, d.imu_channels,
                                  d.imu_window_size)
    return bank


def _sample_runs(train_df, k: int, runs: int):
    """Each run's rows (positions in ``train_df``) and labels, ``(R, n)`` each, drawn
    as ``FewShotSampler.sample_k_per_class(k, seed=run + 42)`` draws them."""
    df = train_df.reset_index(drop=True).copy()
    df["bank_idx"] = np.arange(len(df))
    idx_runs, label_runs = [], []
    for run in range(runs):
        subset = FewShotSampler(df).sample_k_per_class(k, seed=run + 42)
        idx_runs.append(subset["bank_idx"].to_numpy())
        label_runs.append(subset["label"].to_numpy(np.int32))
    return np.stack(idx_runs), np.stack(label_runs)


def _balanced_accuracy_batch(cms: torch.Tensor) -> torch.Tensor:
    """Balanced accuracy (%) per run from ``(R, C, C)`` confusions (rows true): the
    mean recall over the classes present."""
    support = cms.sum(dim=2)
    tp = torch.diagonal(cms, dim1=1, dim2=2)
    recall = torch.where(support > 0, tp / torch.clamp(support, min=1), torch.zeros_like(tp))
    present = (support > 0).sum(dim=1)
    return 100.0 * recall.sum(dim=1) / torch.clamp(present, min=1)


def _per_run(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-run ``(R,)`` vector shaped to broadcast over ``like``'s ``(R, ...)``."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


class BatchedAdamW:
    """``train.optim.AdamW`` over R runs stacked on each tensor's leading axis: the
    global-norm clip per run (each run's norm over its own slice of every gradient),
    then AdamW per group at ``schedule(count)``; a group whose schedule is ``None``
    takes no update (the linear probe's encoder)."""

    def __init__(self, params: Dict[str, torch.Tensor], groups: Sequence, *, max_norm: float, weight_decay: float):
        self.params = params
        self.groups = [(list(names), schedule) for names, schedule in groups]
        self.trained = [n for names, schedule in self.groups if schedule is not None for n in names]
        self.max_norm, self.weight_decay = float(max_norm), float(weight_decay)
        self.count = 0
        self.mu = [torch.zeros_like(params[n]) for n in self.trained]
        self.nu = [torch.zeros_like(params[n]) for n in self.trained]

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        leaves = list(grads.values())
        R = leaves[0].shape[0]
        g_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.reshape(R, -1), dim=1) for g in leaves]), dim=0)
        keep = g_norm < self.max_norm
        one = torch.ones_like(g_norm)
        div, mul = torch.where(keep, one, g_norm), torch.where(keep, one, one * self.max_norm)
        g = [grads[n] / _per_run(div, grads[n]) * _per_run(mul, grads[n]) for n in self.trained]
        count = self.count
        self.count += 1
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - B2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - B1**self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1.0 - B2**self.count))
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mu_hat, denom)
        trained = [self.params[n] for n in self.trained]
        torch._foreach_add_(updates, trained, alpha=self.weight_decay)
        start = 0
        for names, schedule in self.groups:
            if schedule is not None and names:
                torch._foreach_add_(trained[start:start + len(names)], updates[start:start + len(names)],
                                    alpha=-schedule(count))
                start += len(names)


class BatchedRuns:
    """R IMU classifiers in ``mode`` ("linear_probe": the encoder frozen; "finetune"),
    loaded from the flax-layout ``trees`` on ``device`` and stacked on a leading axis,
    with their optimizer. ``train_step`` takes ``(R, B, C, T)`` windows and ``(R, B)``
    labels; ``predict`` one ``(B, C, T)`` batch for every run."""

    def __init__(self, config, mode: str, trees: Sequence[Mapping], *, device, steps_per_epoch: int):
        if mode not in ("linear_probe", "finetune"):
            raise ValueError(f"Unknown classification mode: {mode}")
        self.config = config
        self.precision = _precision(config)
        models = [_masters(IMUClassifier(config, freeze_encoder=mode == "linear_probe"), t, device) for t in trees]
        self.base = models[0]
        self.use_dtypes = self.base.use_dtypes
        self.runs = len(models)
        with torch.no_grad():
            self.params = {n: torch.stack([dict(m.named_parameters())[n].detach() for m in models])
                           for n, _ in self.base.named_parameters()}
            self.buffers = {n: torch.stack([dict(m.named_buffers())[n] for m in models]) for n, _ in self.base.named_buffers()}
        t = config.training
        groups = classification_groups(self.base)
        names = {id(p): n for n, p in self.base.named_parameters()}
        encoder = None if mode == "linear_probe" else classification_schedule(float(t.train_lr_encoder), config, steps_per_epoch)
        head = classification_schedule(float(t.train_lr_head), config, steps_per_epoch)
        self.optimizer = BatchedAdamW(
            self.params,
            [([names[id(p)] for p in groups["encoder"]], encoder), ([names[id(p)] for p in groups["head"]], head)],
            max_norm=float(t.grad_clip_norm), weight_decay=float(t.pretrain_weight_decay),
        )

    def _call(self, params, buffers, imu, *, train: bool, generator=None):
        cast = {n: p.to(self.use_dtypes[n]) for n, p in params.items()}
        return torch.func.functional_call(self.base, {**cast, **buffers}, (imu,), {"train": train, "generator": generator})

    def _loss(self, params, buffers, imu, label, generator):
        logits, _ = self._call(params, buffers, imu, train=True, generator=generator)
        return L.cross_entropy_loss(logits, label), logits

    def gradients(self, imu: torch.Tensor, label: torch.Tensor, generator=None):
        """``(grads, losses (R,), logits (R, B, classes))`` of one train forward; the
        BatchNorm statistics move, the parameters do not."""
        fn = torch.func.grad_and_value(functools.partial(self._loss, generator=generator), has_aux=True)
        with precision_scope(self.precision):
            grads, (loss, logits) = torch.func.vmap(fn, randomness="different")(self.params, self.buffers, imu, label)
        return grads, loss, logits

    def train_step(self, imu: torch.Tensor, label: torch.Tensor, generator=None) -> Dict[str, torch.Tensor]:
        """One update of every run in place; returns each run's ``loss`` and
        ``accuracy`` (%) as ``(R,)`` tensors on the device."""
        grads, loss, logits = self.gradients(imu, label, generator)
        with precision_scope(self.precision):
            self.optimizer.step(grads)
        hits = (torch.argmax(logits.detach(), dim=-1) == label).float()
        return {"loss": loss.detach(), "accuracy": hits.mean(dim=1) * 100.0}

    @torch.no_grad()
    def predict(self, imu: torch.Tensor, params: Optional[Mapping] = None) -> torch.Tensor:
        """Every run's eval logits ``(R, B, classes)`` on the shared batch ``imu``."""
        fn = lambda p, b: self._call(p, b, imu, train=False)[0]  # noqa: E731
        with precision_scope(self.precision):
            return torch.func.vmap(fn)(self.params if params is None else params, self.buffers)


def _confusions(runs: BatchedRuns, bank: torch.Tensor, labels: torch.Tensor, num_classes: int, params=None) -> torch.Tensor:
    """Each run's ``(R, C, C)`` confusion matrix over a shared evaluation set on the
    device, in zero-padded batches of ``EVAL_BS``."""
    cms = torch.zeros((runs.runs, num_classes, num_classes), dtype=torch.float32, device=bank.device)
    for start in range(0, len(labels), EVAL_BS):
        imu, lab = bank[start:start + EVAL_BS], labels[start:start + EVAL_BS]
        n = len(lab)
        if n < EVAL_BS:
            imu = torch.cat([imu, imu.new_zeros((EVAL_BS - n,) + imu.shape[1:])])
            lab = torch.cat([lab, lab.new_zeros(EVAL_BS - n)])
        preds = torch.argmax(runs.predict(imu, params), dim=-1)  # (R, EVAL_BS)
        valid = (torch.arange(EVAL_BS, device=bank.device) < n).float()
        true = torch.nn.functional.one_hot(lab, num_classes).float() * valid[:, None]
        cms += torch.einsum("bt,rbp->rtp", true, torch.nn.functional.one_hot(preds, num_classes).float())
    return cms


def init_run_trees(config, mode: str, encoder_params, runs: int, generator: torch.Generator) -> List[Dict]:
    """``runs`` fresh ``IMUClassifier`` trees, each drawn with ``bridge.init_params`` from
    its own seed out of ``generator``, their ``imu_encoder`` replaced by
    ``encoder_params`` when given (every run starts from the same pretrained encoder)."""
    trees = []
    for seed in split_seeds(generator, runs):
        tree = init_params(config, torch.Generator().manual_seed(seed), IMUClassifier)
        trees.append(_graft_encoder(tree, encoder_params) if encoder_params is not None else tree)
    return trees


def fewshot_cell(
    config, mode: str, trees: Sequence[Mapping], train_bank: np.ndarray, idx_runs: np.ndarray, label_runs: np.ndarray,
    fit_bank: np.ndarray, fit_labels: np.ndarray, test_bank: np.ndarray, test_labels: np.ndarray, *, device,
    generator: torch.Generator, run_ids: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Train the runs of one cell together from ``trees`` (one per run) on their rows
    ``idx_runs`` ``(R, n)`` of ``train_bank`` (labels ``label_runs``), select each run's
    best epoch on ``fit_bank``, and return each run's ``(R, C, C)`` confusion on the
    test set. ``run_ids`` (default ``0..R-1``) seed each run's batch order, so that a
    run trained alone (``run_ids=[r]``) sees the batches it sees in the stack;
    ``generator`` (on ``device``) draws the dropout masks."""
    t, C = config.training, config.model.num_classes
    R, n_sub = idx_runs.shape
    run_ids = list(range(R)) if run_ids is None else list(run_ids)
    bs = min(TRAIN_BS, n_sub)
    spe = max(n_sub // bs, 1)
    runs = BatchedRuns(config, mode, trees, device=device, steps_per_epoch=spe)
    train_dev = torch.from_numpy(np.ascontiguousarray(train_bank)).to(device)
    fit_dev = torch.from_numpy(np.ascontiguousarray(fit_bank)).to(device)
    fit_lab = torch.from_numpy(np.asarray(fit_labels, np.int64)).to(device)
    stopper = PerRunEarlyStopper(R, int(t.patience))
    best = {n: p.clone() for n, p in runs.params.items()}  # before the first step changes them
    for epoch in range(int(t.train_epochs)):
        order = np.stack([np.random.default_rng((run + 42) * 1000 + epoch).permutation(n_sub) for run in run_ids])
        rows = torch.from_numpy(np.take_along_axis(idx_runs, order, axis=1)).to(device)
        labels = torch.from_numpy(np.take_along_axis(label_runs, order, axis=1).astype(np.int64)).to(device)
        for b in range(spe):
            sl = slice(b * bs, (b + 1) * bs)
            runs.train_step(train_dev[rows[:, sl]], labels[:, sl], generator)
        bal = _balanced_accuracy_batch(_confusions(runs, fit_dev, fit_lab, C)).cpu().numpy()
        improved = stopper.update(bal)
        if improved.any():
            mask = torch.from_numpy(improved).to(device)
            with torch.no_grad():
                for n, p in runs.params.items():
                    best[n] = torch.where(_per_run(mask, p), p, best[n])
        if stopper.all_stopped:
            break
    test_dev = torch.from_numpy(np.ascontiguousarray(test_bank)).to(device)
    test_lab = torch.from_numpy(np.asarray(test_labels, np.int64)).to(device)
    return _confusions(runs, test_dev, test_lab, C, params=best).cpu().numpy()


def fewshot_rows(
    config, encoder_params, train_bank: np.ndarray, samples: Mapping[int, tuple], fit_bank: np.ndarray,
    fit_labels: np.ndarray, test_bank: np.ndarray, test_labels: np.ndarray, *, device,
    generator: Optional[torch.Generator] = None, experiment_name: str = "default", verbose: bool = True,
    log: Callable[[str], None] = print,
) -> List[Dict]:
    """The grid on arrays: for each ``n_samples`` in ``samples`` (its ``(idx_runs,
    label_runs)``) and each of ``eval.eval_modes``, one ``fewshot_cell``; returns the
    rows of the sequential harness (experiment, n_samples, run, mode and the metrics).
    ``generator`` (default ``training.seed``) gives each cell its initial trees and
    its dropout seed."""
    generator = default_generator(config, generator)
    rows: List[Dict] = []
    for n_samples, (idx_runs, label_runs) in samples.items():
        for mode in config.eval.eval_modes:
            trees = init_run_trees(config, mode, encoder_params, idx_runs.shape[0], generator)
            fit = torch.Generator(device=device).manual_seed(split_seeds(generator, 1)[0])
            cms = fewshot_cell(config, mode, trees, train_bank, idx_runs, label_runs, fit_bank, fit_labels,
                               test_bank, test_labels, device=device, generator=fit)
            metrics = [metrics_from_confusion(cm) for cm in cms]
            rows += [{"experiment": experiment_name, "n_samples": n_samples, "run": run, "mode": mode, **m}
                     for run, m in enumerate(metrics)]
            if verbose:
                per_run = [f"{m['balanced_accuracy']:.1f}" for m in metrics]
                log(f"[FewShot‖] {experiment_name} n={n_samples} {mode}: bal_acc per run = {per_run}")
    return rows


def run_parallel_fewshot(
    config, encoder_params, train_df, test_df, val_df=None, experiment_name: str = "default",
    generator: Optional[torch.Generator] = None, verbose: bool = True, *, device,
):
    """The few-shot grid over manifests, every cell's runs batched; returns the
    sequential harness's DataFrame. Fits on ``val_df``, or on the test set when it is
    missing or ``eval.replicate_test_as_val`` is set (quirk Q4)."""
    import pandas as pd

    e = config.eval
    train_bank, test_bank = load_window_bank(train_df, config), load_window_bank(test_df, config)
    test_labels = test_df["label"].to_numpy(np.int32)
    if e.replicate_test_as_val or val_df is None:
        fit_bank, fit_labels = test_bank, test_labels
    else:
        fit_bank, fit_labels = load_window_bank(val_df, config), val_df["label"].to_numpy(np.int32)
    samples = {n: _sample_runs(train_df, n, int(e.few_shot_runs)) for n in e.few_shot_samples}
    return pd.DataFrame(fewshot_rows(
        config, encoder_params, train_bank, samples, fit_bank, fit_labels, test_bank, test_labels, device=device,
        generator=generator, experiment_name=experiment_name, verbose=verbose,
    ))
