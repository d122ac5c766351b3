"""Out-of-distribution scores (``tpuhar/ood.py``); every score is higher = more likely
OOD, and AUROC treats OOD as the positive class.

Logit-space: ``msp_score`` and ``energy_score``. Embedding-space: ``MahalanobisScorer``,
``RelativeMahalanobisScorer`` and ``KNNScorer``. Each is fitted on the host exactly as
the JAX package fits it (the two Mahalanobis forms in float64 numpy, KNN with its
seeded subsample and L2 normalization) and holds its fitted arrays as f32 tensors;
``to(device)`` moves them once, and ``score`` is plain tensor code in full f32 (TF32
off, the counterpart of ``Precision.HIGHEST``) that a CUDA graph can capture. The
thresholds (``fit_ood_thresholds``, ``fpr_at_tpr``) are numpy, as in the reference.
The leave-one-activity-out harness is not ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def full_f32():
    """Full f32 for matmuls and cuDNN convolutions inside the scope (no TF32)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def msp_score(logits: torch.Tensor) -> torch.Tensor:
    """Maximum-softmax-probability score: ``1 - max_c p(c|x)``."""
    return 1.0 - torch.softmax(logits.float(), dim=-1).max(dim=-1).values


def energy_score(logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Energy score: ``-T · logsumexp(logits / T)``."""
    t = float(temperature)
    return -t * torch.logsumexp(logits.float() / t, dim=-1)


def _host(x, dtype) -> np.ndarray:
    """An array or tensor as a numpy array of ``dtype`` on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _gaussian(x: np.ndarray, eps: float):
    """Mean and precision of one Gaussian over the rows of ``x`` (float64), with the
    covariance regularized by ``eps·trace/D`` and 1e-6 on its diagonal."""
    D = x.shape[-1]
    mean = x.mean(0)
    c = x - mean
    cov = (c.T @ c) / max(x.shape[0], 1)
    cov = cov + eps * np.trace(cov) / D * np.eye(D) + 1e-6 * np.eye(D)
    return mean, np.linalg.inv(cov)


class _Fitted:
    """``to(device)``: a copy with every tensor field on ``device``."""

    def to(self, device):
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **moved)

    def _input(self, embeddings) -> torch.Tensor:
        device = getattr(self, dataclasses.fields(self)[0].name).device
        return torch.as_tensor(embeddings).to(device=device, dtype=torch.float32)


def _quadratic(diff: torch.Tensor, precision: torch.Tensor) -> torch.Tensor:
    """``diff · P · diff`` over the last axis, in full f32."""
    with full_f32():
        return ((diff @ precision) * diff).sum(dim=-1)


@dataclass
class MahalanobisScorer(_Fitted):
    """Class-conditional Gaussian with shared covariance over ID embeddings: the score
    is the least squared Mahalanobis distance to any class mean."""

    means: torch.Tensor  # (C, D) f32
    precision: torch.Tensor  # (D, D) f32

    @classmethod
    def fit(cls, embeddings, labels, num_classes: int, eps: float = 1e-3) -> "MahalanobisScorer":
        # float64 on the host: the tied covariance of a few hundred D-dim embeddings is
        # near-singular, and its inverse amplifies any rounding of X^T X
        x = _host(embeddings, np.float64)
        y = _host(labels, np.int64)
        D = x.shape[-1]
        one_hot = np.eye(num_classes, dtype=np.float64)[y]  # (N, C)
        counts = np.maximum(one_hot.sum(0), 1.0)
        means = (one_hot.T @ x) / counts[:, None]  # (C, D)
        centered = x - means[y]
        cov = (centered.T @ centered) / max(x.shape[0], 1)
        cov = cov + eps * np.trace(cov) / D * np.eye(D) + 1e-6 * np.eye(D)
        return cls(means=_f32(means), precision=_f32(np.linalg.inv(cov)))

    def score(self, embeddings) -> torch.Tensor:
        x = self._input(embeddings)
        diff = x[:, None, :] - self.means[None, :, :]  # (N, C, D)
        return _quadratic(diff, self.precision).min(dim=-1).values


@dataclass
class RelativeMahalanobisScorer(_Fitted):
    """Relative Mahalanobis distance (Ren et al. 2021): the class-conditional distance
    minus the distance under one class-agnostic background Gaussian."""

    means: torch.Tensor  # (C, D)
    precision: torch.Tensor  # (D, D)
    mean0: torch.Tensor  # (D,)
    precision0: torch.Tensor  # (D, D)

    @classmethod
    def fit(cls, embeddings, labels, num_classes: int, eps: float = 1e-3) -> "RelativeMahalanobisScorer":
        base = MahalanobisScorer.fit(embeddings, labels, num_classes, eps=eps)
        mean0, precision0 = _gaussian(_host(embeddings, np.float64), eps)
        return cls(means=base.means, precision=base.precision, mean0=_f32(mean0), precision0=_f32(precision0))

    def score(self, embeddings) -> torch.Tensor:
        x = self._input(embeddings)
        md = _quadratic(x[:, None, :] - self.means[None, :, :], self.precision)
        md0 = _quadratic(x - self.mean0[None, :], self.precision0)
        return md.min(dim=-1).values - md0


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


@dataclass
class KNNScorer(_Fitted):
    """Deep nearest-neighbour OOD score (Sun et al., ICML 2022): the distance from the
    L2-normalized embedding to its k-th nearest neighbour in an L2-normalized bank of ID
    embeddings, from one similarity product (``d² = 2 − 2·sim`` for unit vectors) and
    ``torch.topk``."""

    bank: torch.Tensor  # (N, D) L2-normalized ID embeddings
    k: int = 10

    @classmethod
    def fit(cls, embeddings, k: int = 10, max_bank: int = 20000, seed: int = 0) -> "KNNScorer":
        x = _host(embeddings, np.float32)
        if x.shape[0] > max_bank:  # bound the bank: one product row per test point
            idx = np.random.default_rng(seed).choice(x.shape[0], size=max_bank, replace=False)
            x = x[np.sort(idx)]
        return cls(bank=_unit_rows(_f32(x)), k=min(int(k), x.shape[0]))

    def score(self, embeddings) -> torch.Tensor:
        z = _unit_rows(self._input(embeddings))
        with full_f32():
            sims = z @ self.bank.T  # (M, N)
        kth = torch.topk(sims, self.k, dim=-1).values[:, -1]
        return torch.sqrt(torch.clamp(2.0 - 2.0 * kth, min=0.0))


def compute_ood_scores(
    logits,
    embeddings=None,
    *,
    mahalanobis: Optional[MahalanobisScorer] = None,
    knn: Optional[KNNScorer] = None,
    rmd: Optional[RelativeMahalanobisScorer] = None,
    energy_temperature: float = 1.0,
    scores: Optional[List[str]] = None,
) -> Dict[str, np.ndarray]:
    """All requested OOD scores of a batch, as numpy arrays: ``msp``/``energy``
    (logit-space), ``mahalanobis``/``rmd``/``knn`` (embedding-space; each needs its
    fitted scorer and the embeddings)."""
    scores = scores or ["msp", "energy", "mahalanobis"]
    logits = torch.as_tensor(logits)
    out: Dict[str, np.ndarray] = {}
    if "msp" in scores:
        out["msp"] = msp_score(logits).cpu().numpy()
    if "energy" in scores:
        out["energy"] = energy_score(logits, energy_temperature).cpu().numpy()
    for name, scorer in (("mahalanobis", mahalanobis), ("knn", knn), ("rmd", rmd)):
        if name in scores and scorer is not None and embeddings is not None:
            out[name] = scorer.score(embeddings).cpu().numpy()
    return out


def fit_ood_thresholds(id_scores: Dict[str, np.ndarray], id_fpr: float = 0.05) -> Dict[str, float]:
    """Per-score decision thresholds from ID-only calibration data: for each score the
    ``1 - id_fpr`` quantile of its ID values, so that flagging ``score >= threshold``
    rejects about ``id_fpr`` of ID inputs. Returns ``{score_name: threshold}``."""
    if not 0.0 < id_fpr < 1.0:
        raise ValueError(f"id_fpr must be in (0, 1), got {id_fpr}")
    return {name: float(np.quantile(np.asarray(s, np.float64), 1.0 - id_fpr)) for name, s in id_scores.items()}


def fpr_at_tpr(ood_scores, is_ood, tpr: float = 0.95) -> float:
    """False-positive rate at the threshold reaching ``tpr`` true-positive rate (OOD
    = positive)."""
    s = np.asarray(ood_scores, dtype=np.float64)
    pos = np.asarray(is_ood).astype(bool)
    if pos.sum() == 0 or (~pos).sum() == 0:
        return float("nan")
    thresh = np.quantile(s[pos], 1.0 - tpr)
    return float((s[~pos] >= thresh).mean())
