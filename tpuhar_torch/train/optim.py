"""The optimizers and learning-rate schedules of pretraining and classification
(``tpuhar/train/optim.py``), as optax computes them.

``pretrain_schedule``: linear warmup from 0.1·lr to lr over ``pretrain_warmup_epochs``,
then cosine decay to 1e-6, per step, with the warmup=0 guard. ``make_pretrain_optimizer``:
``optax.chain(clip_by_global_norm(grad_clip_norm), adamw(schedule, weight_decay))``,
written out: optax clips by ``(g / ‖g‖) · max_norm`` once ‖g‖ ≥ max_norm (no ``+1e-6``, as
``torch.nn.utils.clip_grad_norm_`` adds), evaluates the schedule at the count before the
update (step 0 runs at 0.1·lr), and its ``adamw`` decays every parameter: biases, norms
and the SigLIP scalars included.

``classification_schedule``: cosine decay from a base rate to 1e-7 over
``train_epochs``. ``make_classification_optimizer``: the global-norm clip over every
gradient, then ``optax.multi_transform`` of two groups, the ``imu_encoder`` subtree
("encoder") and everything else ("head"): AdamW at ``train_lr_head`` for the head; for
the encoder AdamW at ``train_lr_encoder`` (``finetune``) or ``optax.set_to_zero``
(``linear_probe``: no update, no moments, no weight decay, so the encoder's parameters
stay as they were, bit for bit).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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


def classification_schedule(base_lr: float, config, steps_per_epoch: int) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` from ``base_lr`` to 1e-7 over ``train_epochs``."""
    total = max(int(config.training.train_epochs) * steps_per_epoch, 1)
    base_lr = float(base_lr)
    alpha = 1e-7 / max(base_lr, 1e-12)

    def cosine(count: int) -> float:
        c = 0.5 * (1.0 + math.cos(math.pi * min(count, total) / total))
        return base_lr * ((1.0 - alpha) * c + alpha)

    return cosine


class AdamW:
    """Global-norm clipping over every parameter's gradient, then AdamW (b1 0.9, b2
    0.999, eps 1e-8, decoupled weight decay on every parameter of a group) per group at
    its ``schedule(count)``, over the parameters' ``.grad``.

    ``groups`` is a sequence of ``(parameters, schedule)``; a group whose schedule is
    ``None`` takes no update (``optax.set_to_zero``): its gradients count in the clip's
    norm only, and it keeps no moments. ``params`` lists every parameter, ``mu`` and
    ``nu`` the moments of the updated ones in group order. The update runs on the
    parameters' device as a few multi-tensor kernels and reads nothing back to the host;
    each updated group adds one host float, its learning rate.

    Over a mesh's model axis (``split_over_model``, set by ``parallel.mesh.shard_state``)
    a split parameter's gradient is this rank's block: the squares of the split ones are
    summed over the model group and the replicated ones counted once, so the clip sees
    the whole model's norm. Weight decay and the moments act element by element, on each
    rank's block."""

    def __init__(self, groups: Sequence[Tuple[Iterable[torch.nn.Parameter], Optional[Callable[[int], float]]]], *,
                 max_norm: float, weight_decay: float):
        self.groups = [(list(params), schedule) for params, schedule in groups]
        self.params = [p for params, _ in self.groups for p in params]
        self.trained = [p for params, schedule in self.groups if schedule is not None for p in params]
        self.max_norm, self.weight_decay = float(max_norm), float(weight_decay)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.trained]
        self.nu = [torch.zeros_like(p) for p in self.trained]
        self.model_split = None  # (ModelShard, a flag per parameter: split over the model axis)

    def split_over_model(self, shard, split) -> None:
        """Clip by the whole model's norm where the parameters flagged in ``split`` (one
        flag per entry of ``params``) hold this rank's block over ``shard``'s group."""
        self.model_split = (shard, list(split))

    def _global_norm(self) -> torch.Tensor:
        """‖g‖ over every gradient (a parameter without one adds 0)."""
        if self.model_split is None:
            present = [p.grad for p in self.params if p.grad is not None]
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(present)))
        shard, split = self.model_split
        device = self.params[0].device
        sums = []
        for flag in (True, False):
            grads = [p.grad for p, f in zip(self.params, split) if f == flag and p.grad is not None]
            norms = torch._foreach_norm(grads) if grads else [torch.zeros((), device=device)]
            sums.append(torch.stack(norms).float().square().sum())
        dist.all_reduce(sums[0], group=shard.group)  # every rank of the group calls it
        return torch.sqrt(sums[0] + sums[1])

    @torch.no_grad()
    def step(self) -> None:
        # optax.clip_by_global_norm over every gradient: (g / ‖g‖) · max_norm unless
        # ‖g‖ < max_norm; a parameter without a gradient adds 0 to the norm
        g_norm = self._global_norm()
        keep = g_norm < self.max_norm
        one = torch.ones_like(g_norm)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.trained]
        grads = torch._foreach_div(grads, torch.where(keep, one, g_norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_norm))
        # optax.scale_by_adam, add_decayed_weights, scale_by_learning_rate (each group's
        # schedule at the count before this update)
        count = self.count
        self.count += 1
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - B2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - B1**self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1.0 - B2**self.count))
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(updates, self.trained, alpha=self.weight_decay)
        start = 0
        for params, schedule in self.groups:
            if schedule is not None and params:
                torch._foreach_add_(params, updates[start:start + len(params)], alpha=-schedule(count))
                start += len(params)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        if len(state["mu"]) != len(self.mu) or len(state["nu"]) != len(self.nu):
            raise ValueError("optimizer state does not match the parameters")
        self.count = int(state["count"])
        with torch.no_grad():
            for mine, theirs in zip([*self.mu, *self.nu], [*state["mu"], *state["nu"]]):
                mine.copy_(theirs)


def make_pretrain_optimizer(config, steps_per_epoch: int, params) -> AdamW:
    """``optax.chain(clip_by_global_norm, adamw)`` of the pretraining stage over ``params``:
    one group, every parameter at the pretraining schedule."""
    t = config.training
    return AdamW(
        [(params, pretrain_schedule(config, steps_per_epoch))],
        max_norm=float(t.grad_clip_norm), weight_decay=float(t.pretrain_weight_decay),
    )


def classification_groups(model: torch.nn.Module) -> Dict[str, list]:
    """The parameters of ``model`` by group: its ``imu_encoder`` subtree is "encoder",
    everything else "head" (``tpuhar/train/optim.py: _param_group_labels``)."""
    groups = {"encoder": [], "head": []}
    for name, p in model.named_parameters():
        groups["encoder" if name.split(".")[0] == "imu_encoder" else "head"].append(p)
    return groups


def make_classification_optimizer(config, steps_per_epoch: int, mode: str, model: torch.nn.Module) -> AdamW:
    """The classification stage's optimizer over ``model``'s parameters: ``linear_probe``
    updates the head only; ``finetune`` the encoder at ``train_lr_encoder`` and the head
    at ``train_lr_head``. Both clip at ``grad_clip_norm`` over every gradient first."""
    t = config.training
    if mode == "linear_probe":
        encoder_schedule = None
    elif mode == "finetune":
        encoder_schedule = classification_schedule(float(t.train_lr_encoder), config, steps_per_epoch)
    else:
        raise ValueError(f"Unknown classification mode: {mode}")
    head_schedule = classification_schedule(float(t.train_lr_head), config, steps_per_epoch)
    groups = classification_groups(model)
    return AdamW(
        [(groups["encoder"], encoder_schedule), (groups["head"], head_schedule)],
        max_norm=float(t.grad_clip_norm), weight_decay=float(t.pretrain_weight_decay),
    )
