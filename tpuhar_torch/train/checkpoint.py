"""Checkpoints of a ``TrainState`` (``tpuhar/train/checkpoint.py``): a pair of files,
``<name>.pt`` (``torch.save`` of the model's parameters and buffers, the optimizer's
moments and count, which is also the schedule's position, and the step) and
``<name>.json`` (epoch, history and best metric, human-readable). The trainer keeps
``last``, ``best_model`` and ``checkpoint_epoch_N`` pairs; ``save_params`` writes the
pipeline's bare ``final_model_params.pt``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch


def save_checkpoint(path, state, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state`` to ``<path>.pt`` and ``extra`` to ``<path>.json``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
    }
    torch.save(payload, path.with_suffix(".pt"))
    path.with_suffix(".json").write_text(json.dumps(dict(extra or {}), indent=2, default=str))


def restore_checkpoint(path, state, *, model_only: bool = False) -> Tuple[Any, Dict[str, Any]]:
    """Load ``<path>.pt`` into ``state`` in place (onto its model's device); returns
    ``(state, sidecar dict)``. ``model_only`` loads the model's parameters and buffers
    and the step, and leaves the optimizer as it is (a checkpoint of another optimizer,
    such as a linear probe's, serves a finetune task's model so)."""
    path = Path(path)
    device = next(state.model.parameters()).device
    payload = torch.load(path.with_suffix(".pt"), map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    if not model_only:
        state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    sidecar = path.with_suffix(".json")
    return state, (json.loads(sidecar.read_text()) if sidecar.exists() else {})


def checkpoint_exists(path) -> bool:
    return Path(path).with_suffix(".pt").exists()


def save_params(path, model) -> None:
    """The model's parameters alone, ``{name: tensor}`` in ``<path>.pt`` (the JAX
    package's ``final_model_params.msgpack``)."""
    path = Path(path).with_suffix(".pt")
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({name: p.detach() for name, p in model.named_parameters()}, path)
