"""Contrastive and classification losses (``tpuhar/losses.py``): SigLIP, InfoNCE,
cross-entropy, focal, label-smoothed and class-weighted cross-entropy, as plain
functions of embeddings and logits, and ``get_loss_function``, the factory by name.

Quirk Q2 of the reference: its SigLIP is ``BCEWithLogits(logits·labels, (labels+1)/2)``
with ``labels = 2·eye − 1``, whose off-diagonal term degenerates to the attractive
``softplus(−logits)``. ``siglip_loss`` is correct SigLIP by default;
``quirk_sign_flip=True`` reproduces the reference's formula.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``jax.nn.softplus`` computes it (``logaddexp(x, 0)``; torch's
    ``softplus`` returns ``x`` above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _valid(B: int, n_valid, device) -> torch.Tensor:
    return torch.arange(B, device=device) < torch.as_tensor(n_valid, device=device)


def siglip_loss(imu_embeds, video_embeds, log_temperature, bias, *, quirk_sign_flip: bool = False, n_valid=None):
    """Sigmoid contrastive loss over the all-pairs similarity of unit-norm ``(B, D)``
    embeddings: ``logits = (imu · videoᵀ)·exp(log_temperature) + bias``; correct SigLIP
    is ``mean_ij softplus(−z_ij · logits_ij)`` with z = +1 on the diagonal and −1 off it.
    ``n_valid`` averages over the valid × valid pairs only (zero-padded final batches)."""
    imu_embeds, video_embeds = imu_embeds.float(), video_embeds.float()
    B = imu_embeds.shape[0]
    logits = imu_embeds @ video_embeds.T
    logits = logits * torch.exp(log_temperature) + bias
    signs = 2.0 * torch.eye(B, dtype=logits.dtype, device=logits.device) - 1.0
    if quirk_sign_flip:
        targets = (signs + 1.0) / 2.0
        scaled = logits * signs
        loss = _softplus(scaled) - targets * scaled
    else:
        loss = _softplus(-signs * logits)
    if n_valid is None:
        return loss.mean()
    valid = _valid(B, n_valid, loss.device).to(loss.dtype)
    mask = valid[:, None] * valid[None, :]
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    """``"mean"``, ``"sum"``, or anything else: the per-row values as they are."""
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def cross_entropy_loss(logits, labels, *, reduction: str = "mean"):
    """Softmax cross-entropy over integer labels, in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    return _reduce(nll, reduction)


def focal_loss(logits, labels, *, alpha: float = 1.0, gamma: float = 2.0, reduction: str = "mean"):
    """Focal loss ``alpha·(1 − p_t)^gamma · CE``, with ``p_t = exp(−CE)``."""
    ce = cross_entropy_loss(logits, labels, reduction="none")
    pt = torch.exp(-ce)
    return _reduce(alpha * (1.0 - pt) ** gamma * ce, reduction)


def label_smoothing_cross_entropy(logits, labels, *, epsilon: float = 0.1, reduction: str = "mean"):
    """Cross-entropy against ``(1 − epsilon)·one_hot + epsilon/n``."""
    n = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    one_hot = F.one_hot(labels.long(), n).to(logp.dtype)
    smoothed = one_hot * (1.0 - epsilon) + epsilon / n
    return _reduce(-(smoothed * logp).sum(dim=-1), reduction)


def weighted_cross_entropy_loss(logits, labels, class_weights):
    """Class-weighted cross-entropy: ``Σ w_y·nll / max(Σ w_y, 1e-8)``."""
    nll = cross_entropy_loss(logits, labels, reduction="none")
    w = torch.as_tensor(class_weights, device=nll.device)[labels.long()]
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)


def infonce_loss(imu_embeds, video_embeds, temperature: float = 0.07, *, n_valid=None):
    """Symmetric InfoNCE at a fixed ``temperature``. ``n_valid`` masks zero-padded rows
    out of the softmax denominators (as candidates) and out of the average (as
    anchors)."""
    imu_embeds, video_embeds = imu_embeds.float(), video_embeds.float()
    B = imu_embeds.shape[0]
    logits = imu_embeds @ video_embeds.T / temperature
    labels = torch.arange(B, device=logits.device)
    if n_valid is None:
        return (cross_entropy_loss(logits, labels) + cross_entropy_loss(logits.T, labels)) / 2.0
    valid = _valid(B, n_valid, logits.device)
    col_mask = torch.where(valid, 0.0, -1e9).to(torch.float32)
    nll_i2v = cross_entropy_loss(logits + col_mask[None, :], labels, reduction="none")
    nll_v2i = cross_entropy_loss(logits.T + col_mask[None, :], labels, reduction="none")
    w = valid.to(torch.float32)
    denom = torch.clamp(w.sum(), min=1.0)
    return ((nll_i2v * w).sum() + (nll_v2i * w).sum()) / (2.0 * denom)


def get_loss_function(loss_name: str, **kwargs):
    """The loss named ``loss_name`` ("sigmoid_contrastive", "infonce", "cross_entropy",
    "focal", "label_smoothing"), with ``kwargs`` bound."""
    table = {
        "sigmoid_contrastive": siglip_loss,
        "infonce": infonce_loss,
        "cross_entropy": cross_entropy_loss,
        "focal": focal_loss,
        "label_smoothing": label_smoothing_cross_entropy,
    }
    if loss_name not in table:
        raise ValueError(f"Unknown loss function: {loss_name}")
    fn = table[loss_name]
    return functools.partial(fn, **kwargs) if kwargs else fn
