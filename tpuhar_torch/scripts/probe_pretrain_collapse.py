"""Which InfoNCE pretraining learning rate keeps the IMU embedding from collapsing on
the hard fixture? (``scripts/probe_pretrain_collapse.py``)

Per learning rate this pretrains on the article work directory's preprocessed windows
(``tiny_cnn`` video tower at 32², so a cell is minutes) and reports, on every val
window's IMU encoder embedding:

- ``perdim_std``, the mean over dimensions of the std over windows, and
  ``var_over_norm2``, the between-window variance over the mean squared norm (a
  collapsed encoder maps every window near one point: both near 0);
- ``sk_probe_heldout_bal``, the balanced accuracy (%) of a linear probe trained on half
  the val embeddings and tested on the other half (a permutation from
  ``default_rng(0)``: the metadata is class-ordered).

The probe is the function the JAX script fits with sklearn's
``LogisticRegression(max_iter=2000)``: a multinomial logistic regression, L2 penalty at
``C = 1`` on the coefficients and none on the intercepts, in float64, stopped at a
gradient of ``1e-4`` by L-BFGS (``fit_logistic_regression``, on the script's device; the
card's machine has no sklearn).

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.probe_pretrain_collapse [epochs=10] [--cpu]``
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ._common import log, script_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("epochs", nargs="?", type=int, default=10)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def collapse_stats(F: np.ndarray) -> dict:
    """``perdim_std`` and ``var_over_norm2`` of the embeddings ``F`` ``(N, D)``, rounded
    as the JAX script rounds them."""
    Fc = F - F.mean(0)
    var = float((Fc**2).sum(1).mean())
    norm2 = float((F**2).sum(1).mean())
    return {"perdim_std": round(float(F.std(0).mean()), 4), "var_over_norm2": round(var / max(norm2, 1e-9), 5)}


def fit_logistic_regression(X, y, *, C: float = 1.0, tol: float = 1e-4, max_iter: int = 2000, device="cpu"):
    """sklearn's ``LogisticRegression(C=C, tol=tol, max_iter=max_iter)`` fit: the
    minimizer of the mean cross-entropy plus ``‖W‖² / (2·C·n)`` (the intercepts
    unpenalized), multinomial over the classes, a single logit (the binary model)
    for two; L-BFGS with a strong-Wolfe line search from zeros in float64, stopped when
    no gradient element exceeds ``tol``. Returns ``(coef (K, D), intercept (K,),
    classes)`` as numpy, ``K = 1`` for two classes, as sklearn's ``coef_``,
    ``intercept_`` and ``classes_``."""
    classes = np.unique(y)
    X = torch.as_tensor(np.asarray(X, np.float64), device=device)
    target = torch.as_tensor(np.searchsorted(classes, y), device=device)
    n, d = X.shape
    k = 1 if len(classes) == 2 else len(classes)
    w = torch.zeros(k, d + 1, dtype=torch.float64, device=device, requires_grad=True)
    alpha = 1.0 / (C * n)

    def objective():
        z = X @ w[:, :d].T + w[:, d]
        if k == 1:
            z = torch.cat([torch.zeros_like(z), z], dim=1)
        return torch.nn.functional.cross_entropy(z, target) + 0.5 * alpha * (w[:, :d] ** 2).sum()

    opt = torch.optim.LBFGS([w], lr=1.0, max_iter=max_iter, tolerance_grad=tol,
                            tolerance_change=64 * np.finfo(np.float64).eps, history_size=10,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = objective()
        loss.backward()
        return loss

    opt.step(closure)
    w = w.detach().cpu().numpy()
    return w[:, :d], w[:, d], classes


def predict_logistic_regression(coef, intercept, classes, X) -> np.ndarray:
    z = np.asarray(X, np.float64) @ coef.T + intercept
    return classes[(z[:, 0] > 0).astype(int)] if coef.shape[0] == 1 else classes[np.argmax(z, 1)]


def balanced_accuracy(y_true, y_pred) -> float:
    """sklearn's ``balanced_accuracy_score``: the mean recall over the classes in ``y_true``."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float(np.mean([(y_pred[y_true == c] == c).mean() for c in np.unique(y_true)]))


def probe_heldout(F: np.ndarray, labels: np.ndarray, device="cpu") -> float:
    """The balanced accuracy (%) on the second half of a ``default_rng(0)`` permutation of
    a probe fitted on the first."""
    idx = np.random.default_rng(0).permutation(len(F))
    n = len(F) // 2
    tr_i, te_i = idx[:n], idx[n:]
    coef, intercept, classes = fit_logistic_regression(F[tr_i], labels[tr_i], max_iter=2000, device=device)
    return balanced_accuracy(labels[te_i], predict_logistic_regression(coef, intercept, classes, F[te_i])) * 100


def embed_windows(cfg, enc_params, enc_stats, windows: np.ndarray, device) -> np.ndarray:
    """The IMU encoder's eval embedding ``(N, D)`` f32 of the ``(N, T, C)`` windows."""
    from ..bridge import load_variables
    from ..models.imu import build_imu_encoder

    enc = build_imu_encoder(cfg, getattr(torch, cfg.model.compute_dtype))
    enc = load_variables(enc, {"params": enc_params, "batch_stats": enc_stats or {}}).to(device).eval()
    x = torch.from_numpy(np.ascontiguousarray(windows.transpose(0, 2, 1), np.float32)).to(device)
    with torch.inference_mode():
        return enc(x, train=False)[0].float().cpu().numpy()


def run(epochs: int = 10, *, device, work="outputs/torch/article_hard", lrs=(5e-4, 2e-4, 1e-4, 5e-5),
        out_root="outputs/torch/probe_pt") -> dict:
    import pandas as pd

    from ..cli import Pipeline
    from ..data.synthetic import make_synthetic_config

    work = Path(work)
    pre = work / "out" / "preprocessed"
    results = {}
    for lr in lrs:
        cfg = make_synthetic_config(
            work / "data", Path(out_root) / f"lr{lr:.0e}",
            num_classes=6, video_backbone="tiny_cnn", video_resize=(32, 32),
            pretrain_epochs=epochs, pretrain_batch_size=64,
        )
        cfg.data.video_frames_per_window = 4
        cfg.model.compute_dtype = "float32"
        cfg.model.head_norm = "layer"
        cfg.training.pretrain_lr = lr
        # the article work directory's windows and frames (the same data directory)
        cfg.paths.preprocessed_dir = pre
        pipe = Pipeline(cfg, device=device)
        pipe.run_pretraining()
        enc_params, enc_stats = pipe._load_pretrained_encoder()
        if enc_params is None:
            raise RuntimeError(f"lr {lr:.0e}: pretraining left no encoder checkpoint")

        labels = pd.read_csv(pre / "val_metadata.csv")["label"].values
        F = embed_windows(cfg, enc_params, enc_stats, np.load(pre / "val_windows.npy"), device)
        bal = probe_heldout(F, labels, device)
        row = results[f"{lr:.0e}"] = {**collapse_stats(F), "sk_probe_heldout_bal": round(bal, 2)}
        log(f"lr={lr:.0e}: perdim_std {row['perdim_std']}, var/norm2 {row['var_over_norm2']}, "
            f"sk-probe held-out bal {bal:.1f}")
    print(json.dumps(results, indent=1))
    return results


def main(argv=None):
    args = parse_args(argv)
    return run(args.epochs, device=script_device(args.cpu))


if __name__ == "__main__":
    main()
