"""The pretraining step in plain PyTorch: the cross-modal model's forward in f32 (TF32
off), SigLIP over the batch, autograd, clipping by the global norm and AdamW, written
out from their definitions.

``pretrain_steps`` runs steps from a flax-layout weight tree and returns what the
benchmark compares: each step's loss, each leaf's first gradient as the optimizer gets
it (after the clip), and each leaf's change after the steps.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F

from .model import Dropout, Precision, batch_norm_train, full_f32, imu_encoder, normalize_clip, vit

_S = Dict[str, torch.Tensor]


def _nested(flat: Mapping, sep: str = "/") -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split(sep)
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _projection(pr: Precision, p, x):
    h = torch.relu(batch_norm_train(pr.dense(x, p["fc1"]), p["bn"]))
    return F.normalize(pr.dense(h, p["fc2"]), dim=-1, eps=1e-12)


def siglip(imu, video, log_t, bias):
    """Sigmoid contrastive loss: mean over all pairs of softplus(−z·ℓ), z = +1 on the
    diagonal and −1 off it, ℓ = (imu · videoᵀ)·exp(log_t) + bias."""
    logits = imu @ video.T * torch.exp(log_t) + bias
    z = 2.0 * torch.eye(logits.shape[0], device=logits.device) - 1.0
    return torch.logaddexp(-z * logits, torch.zeros((), device=logits.device)).mean()


def pretrain_loss(cfg: Mapping, pr: Precision, p, imu, clip_u8, drop: Optional[Dropout]):
    imu_tok = imu_encoder(cfg, pr, p["imu_encoder"], imu, drop)
    emb, _ = vit(cfg, pr, p["video_encoder"]["vit"], normalize_clip(clip_u8), "none", checkpoint=True)
    video = pr.dense(emb, p["video_encoder"]["projection"])
    return siglip(_projection(pr, p["imu_proj"], imu_tok[:, 0]), _projection(pr, p["video_proj"], video),
                  p["temperature"], p["bias"])


def schedule(stage: Mapping, count: int) -> float:
    """Linear warm-up from 0.1·lr to lr over the warm-up epochs, then cosine decay to
    1e-6, at the optimizer's count before the update."""
    t = stage["training"]
    lr, spe = float(t["pretrain_lr"]), int(stage["steps_per_epoch"])
    warm = int(t["pretrain_warmup_epochs"]) * spe
    decay = max(max(int(t["pretrain_epochs"]) * spe, 1) - warm, 1)
    if count < warm:
        return lr * 0.1 + (lr - lr * 0.1) * count / warm
    c = 0.5 * (1.0 + math.cos(math.pi * min(count - warm, decay) / decay))
    alpha = 1e-6 / lr
    return lr * ((1.0 - alpha) * c + alpha)


def pretrain_steps(cfg: Mapping, stage: Mapping, params: _S, batches: List[Dict], generator: Optional[torch.Generator],
                   *, precision: str = "f32") -> Dict:
    """``len(batches)`` steps from ``params`` (``{"a/b/kernel": f32 tensor}``, copied),
    dropout from ``generator``. Returns ``{"loss": [...], "grad1": {leaf: ‖g‖},
    "change": {leaf: ‖θ − θ0‖}}``."""
    t, adam = stage["training"], stage["adamw"]
    pr = Precision(precision)
    theta = {k: v.detach().clone().float().requires_grad_(True) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in theta.items()}
    nu = {k: torch.zeros_like(v) for k, v in theta.items()}
    drop = Dropout(cfg["model"]["imu_dropout"], generator)
    out = {"loss": [], "grad1": {}, "change": {}}
    with full_f32():
        for step, batch in enumerate(batches):
            loss = pretrain_loss(cfg, pr, _nested(theta), batch["imu"], batch["video"], drop)
            grads = torch.autograd.grad(loss, list(theta.values()), allow_unused=True)
            grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(theta.items(), grads)}
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
            factor = 1.0 if norm < t["grad_clip_norm"] else float(t["grad_clip_norm"]) / norm
            lr = schedule(stage, step)
            with torch.no_grad():
                for k, v in theta.items():
                    g = grads[k] * factor
                    if step == 0:
                        out["grad1"][k] = float(torch.linalg.vector_norm(g))
                    mu[k].mul_(adam["b1"]).add_(g, alpha=1.0 - adam["b1"])
                    nu[k].mul_(adam["b2"]).addcmul_(g, g, value=1.0 - adam["b2"])
                    m_hat = mu[k] / (1.0 - adam["b1"] ** (step + 1))
                    v_hat = nu[k] / (1.0 - adam["b2"] ** (step + 1))
                    update = m_hat / (torch.sqrt(v_hat) + adam["eps"]) + t["pretrain_weight_decay"] * v
                    v.sub_(lr * update)
            out["loss"].append(loss.item())
    out["change"] = {k: float(torch.linalg.vector_norm(v.detach() - params[k].float())) for k, v in theta.items()}
    return out
