"""Task factories (``tpuhar/train/factory.py``): the model, its state and its steps for
each stage: cross-modal pretraining, the IMU classifier (linear probe or finetune), the
video-only classifier and the fusion classifier.

Each model is built in the compute dtype, its parameters turned into f32 masters that
receive gradients, and loaded from a flax-layout variable tree (``bridge``) on
``device``. Loading a pretrained IMU encoder into a classifier is a graft of that tree's
``imu_encoder`` subtree (``_graft``); a pretrained video backbone on disk
(``model.video_weights_path``) is converted and grafted into its ``video_encoder``
subtree before the load (``_maybe_graft_video``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

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


def split_seeds(generator: torch.Generator, n: int) -> List[int]:
    """``n`` seeds drawn from ``generator`` (the port's counterpart of
    ``jax.random.split``: each seeds a generator of its own)."""
    return torch.randint(0, 2**62, (n,), generator=generator).tolist()


def default_generator(config, generator: Optional[torch.Generator] = None) -> torch.Generator:
    """``generator``, or a CPU generator seeded ``training.seed`` (the JAX package's
    ``PRNGKey(training.seed)``)."""
    return generator if generator is not None else torch.Generator().manual_seed(int(config.training.seed))


def task_generators(generator: torch.Generator, device):
    """A task's ``(init, fit)`` generators out of ``generator``, in the JAX package's
    order (``rng, init_rng, fit_rng = split(rng, 3)``): ``init`` on the CPU for
    ``bridge.init_params``, ``fit`` on ``device`` for the train steps' dropout."""
    init_seed, fit_seed = split_seeds(generator, 2)
    return torch.Generator().manual_seed(init_seed), torch.Generator(device=device).manual_seed(fit_seed)


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


def _maybe_graft_video(variables: Mapping, config) -> Mapping:
    """``variables`` with the checkpoint at ``model.video_weights_path`` grafted into
    its ``video_encoder`` (``models/convert.graft_model_video_weights``), where a path is
    set and ``model.video_pretrained`` is on; with it off, the skip is printed."""
    m = config.model
    path = getattr(m, "video_weights_path", None)
    if not path:
        return variables
    if not bool(m.video_pretrained):
        print("[factory] model.video_weights_path set but video_pretrained=False - skipping graft")
        return variables
    from ..models.convert import graft_model_video_weights

    params, stats = graft_model_video_weights(variables.get("params", {}), variables.get("batch_stats", {}), config)
    print(f"[factory] grafted pretrained video weights from {path}")
    return {"params": params, "batch_stats": stats}


def _masters(model: torch.nn.Module, variables: Mapping, device) -> torch.nn.Module:
    """``model`` with f32 master parameters that receive gradients, loaded from
    ``variables`` on ``device`` (``.float()`` before the load, so that the masters hold
    the tree's f32 values and not their rounding to the compute dtype)."""
    return load_variables(model.float(), variables).requires_grad_(True).to(device)


def build_crossmodal_task(config, steps_per_epoch: int, params: Mapping, *, device) -> Task:
    """``CrossModalModel(config)`` with f32 masters loaded from the flax-layout tree
    ``params`` on ``device``; the pretraining optimizer and the steps."""
    model = CrossModalModel(config, train_loss_scalars=bool(config.training.train_loss_scalars))
    model = _masters(model, _maybe_graft_video(params, config), device)
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
    model = _masters(VideoClassifier(config), _maybe_graft_video(params, config), device)
    optimizer = make_classification_optimizer(config, steps_per_epoch, "finetune", model)
    train_step, predict_step = make_video_steps(config)
    return Task(model, TrainState(model, optimizer), train_step, predict_step)


def build_fusion_task(
    config, steps_per_epoch: int, params: Mapping, *, encoder_params: Optional[Mapping] = None, device
) -> Task:
    """The fusion classifier (a ``FusionClassifier`` tree ``params``, its ``imu_encoder``
    subtree replaced by ``encoder_params`` when given), trained with the finetune recipe:
    the IMU encoder at ``train_lr_encoder``, everything else at ``train_lr_head``."""
    variables = _maybe_graft_video(_graft_encoder(params, encoder_params), config)
    model = _masters(FusionClassifier(config), variables, device)
    optimizer = make_classification_optimizer(config, steps_per_epoch, "finetune", model)
    train_step, predict_step = make_fusion_steps(config)
    return Task(model, TrainState(model, optimizer), train_step, predict_step)
