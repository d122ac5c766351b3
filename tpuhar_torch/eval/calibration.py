"""Confidence calibration (``tpuhar/eval/calibration.py``): the expected calibration
error and temperature scaling (Guo et al. 2017).

``fit_temperature`` evaluates the held-out NLL of ``logits / T`` over a log-spaced grid
of T in one batched computation on the logits' device (the JAX package's vmapped
program), then refines inside the bracketing interval by golden-section search on the
host, one probe per step. Temperature scaling moves no argmax, so accuracy is
unchanged.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def expected_calibration_error(logits, labels, num_bins: int = 15) -> Dict[str, float]:
    """ECE over ``num_bins`` right-closed confidence bins (confidence 0 in the first),
    the largest bin gap (MCE), the mean confidence and the accuracy, as fractions."""
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().cpu().numpy()
    if isinstance(labels, torch.Tensor):
        labels = labels.detach().cpu().numpy()
    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    conf = probs.max(-1)
    correct = (probs.argmax(-1) == labels).astype(np.float64)
    edges = np.linspace(0.0, 1.0, num_bins + 1)
    idx = np.clip(np.searchsorted(edges, conf, side="left") - 1, 0, num_bins - 1)
    ece, mce, n = 0.0, 0.0, len(conf)
    for b in range(num_bins):
        m = idx == b
        if not m.any():
            continue
        gap = abs(correct[m].mean() - conf[m].mean())
        ece += (m.sum() / n) * gap
        mce = max(mce, gap)
    return {"ece": float(ece), "mce": float(mce), "avg_confidence": float(conf.mean()), "accuracy": float(correct.mean())}


def fit_temperature(logits, labels, t_min: float = 0.05, t_max: float = 20.0, grid_size: int = 64,
                    refine_iters: int = 40) -> float:
    """The temperature that minimizes the held-out NLL: a sweep over ``grid_size``
    log-spaced temperatures in ``[t_min, t_max]`` brackets the minimum (the NLL is
    convex in 1/T), then ``refine_iters`` golden-section steps refine it. ``logits``
    ``(N, C)`` and ``labels`` ``(N,)`` are tensors (on any device) or arrays."""
    lg = torch.as_tensor(logits).float()
    y = torch.as_tensor(labels, device=lg.device).long()

    def nll(ts: torch.Tensor) -> np.ndarray:  # (K,) temperatures → (K,) mean NLLs
        logp = torch.log_softmax(lg[None] / ts[:, None, None], dim=-1)
        picked = torch.gather(logp, 2, y[None, :, None].expand(len(ts), -1, 1))[..., 0]
        return (-picked.mean(dim=1)).cpu().numpy()

    ts = torch.exp(torch.linspace(np.log(t_min), np.log(t_max), grid_size, device=lg.device))
    vals = nll(ts)
    i = int(np.argmin(vals))
    lo, hi = float(ts[max(i - 1, 0)]), float(ts[min(i + 1, grid_size - 1)])

    gr = (np.sqrt(5.0) - 1.0) / 2.0
    probe = lambda t: float(nll(torch.tensor([t], dtype=torch.float32, device=lg.device))[0])  # noqa: E731
    a, b = lo, hi
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = probe(c), probe(d)
    for _ in range(refine_iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = probe(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = probe(d)
    return float((a + b) / 2.0)


def apply_temperature(logits, temperature: float) -> torch.Tensor:
    """``logits / T`` in f32 (argmax unchanged)."""
    lg = torch.as_tensor(logits)
    return lg / torch.tensor(temperature, dtype=torch.float32, device=lg.device)
