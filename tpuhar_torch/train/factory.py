"""Task factories (``tpuhar/train/factory.py``): the model, its state and its steps for
each stage: cross-modal pretraining, the IMU classifier (linear probe or finetune), the
video-only classifier and the fusion classifier.

Each model is built in the compute dtype, its parameters turned into f32 masters that
receive gradients, and loaded from a flax-layout variable tree (``bridge``) on
``device``. Loading a pretrained IMU encoder into a classifier is a graft of that tree's
``imu_encoder`` subtree (``_graft``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import torch

from ..bridge import load_variables
from ..models.crossmodal import CrossModalModel, FusionClassifier, IMUClassifier, VideoClassifier
from .optim import make_classification_optimizer, make_pretrain_optimizer
from .steps import (
    TrainState,
    make_classification_steps,
    make_crossmodal_steps,
    make_fusion_steps,
    make_video_steps,
)


@dataclass
class Task:
    model: torch.nn.Module
    state: TrainState
    train_step: Callable
    eval_step: Callable  # predict_step for the classifiers


def _graft(tree: Mapping, key: str, subtree) -> Dict:
    """``tree`` with ``tree[key]`` replaced by ``subtree`` (a new dict; nothing shared
    is changed)."""
    out = dict(tree)
    out[key] = subtree
    return out


def _graft_encoder(variables: Mapping, encoder_params=None, encoder_batch_stats=None) -> Dict:
    """``variables`` with the ``imu_encoder`` subtree of its params (and of its batch
    statistics, where it has any) replaced by the given ones."""
    params, stats = variables.get("params", {}), variables.get("batch_stats", {})
    if encoder_params is not None:
        params = _graft(params, "imu_encoder", encoder_params)
    if encoder_batch_stats is not None and "imu_encoder" in stats:
        stats = _graft(stats, "imu_encoder", encoder_batch_stats)
    return {"params": params, "batch_stats": stats}


def _no_video_weights(config) -> None:
    if getattr(config.model, "video_weights_path", None):
        raise NotImplementedError(
            "grafting pretrained video weights (weights I/O) is not ported: ROADMAP queue 1 item 6"
        )


def _masters(model: torch.nn.Module, variables: Mapping, device) -> torch.nn.Module:
    """``model`` with f32 master parameters that receive gradients, loaded from
    ``variables`` on ``device`` (``.float()`` before the load, so that the masters hold
    the tree's f32 values and not their rounding to the compute dtype)."""
    return load_variables(model.float(), variables).requires_grad_(True).to(device)


def build_crossmodal_task(config, steps_per_epoch: int, params: Mapping, *, device) -> Task:
    """``CrossModalModel(config)`` with f32 masters loaded from the flax-layout tree
    ``params`` on ``device``; the pretraining optimizer and the steps."""
    _no_video_weights(config)
    model = CrossModalModel(config, train_loss_scalars=bool(config.training.train_loss_scalars))
    model = _masters(model, params, device)
    optimizer = make_pretrain_optimizer(config, steps_per_epoch, model.parameters())
    train_step, eval_step = make_crossmodal_steps(config)
    return Task(model, TrainState(model, optimizer), train_step, eval_step)


def build_classification_task(
    config,
    mode: str,
    steps_per_epoch: int,
    params: Mapping,
    *,
    encoder_params: Optional[Mapping] = None,
    encoder_batch_stats: Optional[Mapping] = None,
    device,
) -> Task:
    """The IMU classifier in ``mode`` ("linear_probe": the encoder frozen; "finetune"),
    loaded from ``params`` (an ``IMUClassifier`` tree) with the ``imu_encoder`` subtree
    replaced by ``encoder_params`` (and its batch statistics by ``encoder_batch_stats``,
    where the tree has any) when given; the classification optimizer and steps."""
    if mode not in ("linear_probe", "finetune"):
        raise ValueError(f"Unknown classification mode: {mode}")
    variables = _graft_encoder(params, encoder_params, encoder_batch_stats)
    model = _masters(IMUClassifier(config, freeze_encoder=mode == "linear_probe"), variables, device)
    optimizer = make_classification_optimizer(config, steps_per_epoch, mode, model)
    train_step, predict_step = make_classification_steps(config)
    return Task(model, TrainState(model, optimizer), train_step, predict_step)


def build_video_task(config, steps_per_epoch: int, params: Mapping, *, device) -> Task:
    """The video-only clip classifier (a ``VideoClassifier`` tree ``params``), trained
    with the finetune recipe (its parameters are all "head")."""
    _no_video_weights(config)
    model = _masters(VideoClassifier(config), params, device)
    optimizer = make_classification_optimizer(config, steps_per_epoch, "finetune", model)
    train_step, predict_step = make_video_steps(config)
    return Task(model, TrainState(model, optimizer), train_step, predict_step)


def build_fusion_task(
    config, steps_per_epoch: int, params: Mapping, *, encoder_params: Optional[Mapping] = None, device
) -> Task:
    """The fusion classifier (a ``FusionClassifier`` tree ``params``, its ``imu_encoder``
    subtree replaced by ``encoder_params`` when given), trained with the finetune recipe:
    the IMU encoder at ``train_lr_encoder``, everything else at ``train_lr_head``."""
    _no_video_weights(config)
    model = _masters(FusionClassifier(config), _graft_encoder(params, encoder_params), device)
    optimizer = make_classification_optimizer(config, steps_per_epoch, "finetune", model)
    train_step, predict_step = make_fusion_steps(config)
    return Task(model, TrainState(model, optimizer), train_step, predict_step)
