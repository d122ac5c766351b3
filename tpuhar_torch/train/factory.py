"""Task factory of the pretraining stage (``tpuhar/train/factory.py:
build_crossmodal_task``): the model, its state and its steps."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import torch

from ..bridge import load_variables
from ..models.crossmodal import CrossModalModel
from .optim import make_pretrain_optimizer
from .steps import TrainState, make_crossmodal_steps


@dataclass
class Task:
    model: torch.nn.Module
    state: TrainState
    train_step: Callable
    eval_step: Callable


def build_crossmodal_task(config, steps_per_epoch: int, params: Mapping, *, device) -> Task:
    """``CrossModalModel(config)`` built in the compute dtype, its parameters turned into
    f32 masters that receive gradients and loaded from the flax-layout tree ``params``,
    on ``device``; the pretraining optimizer and the steps."""
    m = config.model
    if getattr(m, "video_weights_path", None):
        raise NotImplementedError("grafting pretrained video weights (weights I/O) is not ported")
    model = CrossModalModel(config, train_loss_scalars=bool(config.training.train_loss_scalars))
    model = load_variables(model.float(), params).requires_grad_(True).to(device)
    optimizer = make_pretrain_optimizer(config, steps_per_epoch, model.parameters())
    train_step, eval_step = make_crossmodal_steps(config)
    return Task(model, TrainState(model, optimizer), train_step, eval_step)
