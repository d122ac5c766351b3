"""The pretraining optimizer and learning-rate schedule (``tpuhar/train/optim.py``), as
optax computes them.

``pretrain_schedule``: linear warmup from 0.1·lr to lr over ``pretrain_warmup_epochs``,
then cosine decay to 1e-6, per step, with the warmup=0 guard. ``make_pretrain_optimizer``:
``optax.chain(clip_by_global_norm(grad_clip_norm), adamw(schedule, weight_decay))``,
written out: optax clips by ``g · max_norm / ‖g‖`` once ‖g‖ ≥ max_norm (no ``+1e-6``, as
``torch.nn.utils.clip_grad_norm_`` adds), evaluates the schedule at the count before the
update (step 0 runs at 0.1·lr), and its ``adamw`` decays every parameter: biases, norms
and the SigLIP scalars included.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, which the JAX package keeps


def pretrain_schedule(config, steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate as a function of the optimizer's step count."""
    t = config.training
    lr = float(t.pretrain_lr)
    warmup_steps = int(t.pretrain_warmup_epochs) * steps_per_epoch
    total_steps = max(int(t.pretrain_epochs) * steps_per_epoch, 1)
    decay_steps = max(total_steps - warmup_steps, 1)
    alpha = 1e-6 / lr

    def cosine(count: int) -> float:  # optax.cosine_decay_schedule
        c = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return lr * ((1.0 - alpha) * c + alpha)

    if warmup_steps <= 0:  # warmup=0 guard
        return cosine

    def schedule(count: int) -> float:  # optax.join_schedules([linear warmup, cosine])
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (0.1 * lr - lr) * frac + lr
        return cosine(count - warmup_steps)

    return schedule


class PretrainOptimizer:
    """Global-norm clipping, then AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight
    decay on every parameter) at ``schedule(count)``, over ``params``' ``.grad``. The
    update runs on the parameters' device as a few multi-tensor kernels and reads
    nothing back to the host."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable[[int], float], *,
                 max_norm: float, weight_decay: float):
        self.params = list(params)
        self.schedule = schedule
        self.max_norm, self.weight_decay = float(max_norm), float(weight_decay)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        params = self.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        # optax.clip_by_global_norm: g · (max_norm / ‖g‖) unless ‖g‖ < max_norm
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(g_norm < self.max_norm, torch.ones_like(g_norm), self.max_norm / g_norm)
        grads = torch._foreach_mul(grads, factor)
        # optax.scale_by_adam, add_decayed_weights, scale_by_learning_rate
        lr = self.schedule(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - B2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - B1**self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1.0 - B2**self.count))
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(updates, params, alpha=self.weight_decay)
        torch._foreach_add_(params, updates, alpha=-lr)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        if len(state["mu"]) != len(self.mu) or len(state["nu"]) != len(self.nu):
            raise ValueError("optimizer state does not match the parameters")
        self.count = int(state["count"])
        with torch.no_grad():
            for mine, theirs in zip([*self.mu, *self.nu], [*state["mu"], *state["nu"]]):
                mine.copy_(theirs)


def make_pretrain_optimizer(config, steps_per_epoch: int, params) -> PretrainOptimizer:
    """``optax.chain(clip_by_global_norm, adamw)`` of the pretraining stage over ``params``."""
    t = config.training
    return PretrainOptimizer(
        params, pretrain_schedule(config, steps_per_epoch),
        max_norm=float(t.grad_clip_norm), weight_decay=float(t.pretrain_weight_decay),
    )
