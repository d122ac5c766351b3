"""Checkpoints of a ``TrainState`` (``tpuhar/train/checkpoint.py``): a pair of files,
``<name>.pt`` (``torch.save`` of the model's parameters and buffers, the optimizer's
moments and count, which is also the schedule's position, and the step) and
``<name>.json`` (epoch, history and best metric, human-readable). The trainer keeps
``last``, ``best_model`` and ``checkpoint_epoch_N`` pairs; ``save_params`` writes the
pipeline's bare ``final_model_params.pt`` and ``restore_params`` reads it back. The files hold no mesh: under a ``mesh`` every
rank gathers its model group's shards of the split parameters and moments
(``parallel.mesh.whole_state``: a collective every rank enters), rank 0 writes whole
tensors and the others wait at a barrier. A checkpoint written under tensor parallelism
holds the names, shapes and values of one written without a mesh from the same state;
any rank, or a run without a mesh, reads it, and a split state takes its shard of what it
reads (``parallel.mesh.local_state``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..parallel.mesh import barrier, is_main, local_state, whole_state, whole_tensors


def save_checkpoint(path, state, extra: Optional[Dict[str, Any]] = None, *, mesh=None) -> None:
    """Write ``state`` to ``<path>.pt`` and ``extra`` to ``<path>.json`` (every rank of
    ``mesh`` gathers the whole state, rank 0 writes, every rank returns once the files
    are there)."""
    model_sd, opt = whole_state(state)
    if not is_main(mesh):
        barrier(mesh)
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"step": state.step, "model": model_sd, "optimizer": opt}
    torch.save(payload, path.with_suffix(".pt"))
    path.with_suffix(".json").write_text(json.dumps(dict(extra or {}), indent=2, default=str))
    barrier(mesh)


def restore_checkpoint(path, state, *, model_only: bool = False) -> Tuple[Any, Dict[str, Any]]:
    """Load ``<path>.pt`` into ``state`` in place (onto its model's device; a state split
    over a mesh's model axis takes its shard); returns ``(state, sidecar dict)``.
    ``model_only`` loads the model's parameters and buffers and the step, and leaves the
    optimizer as it is (a checkpoint of another optimizer, such as a linear probe's,
    serves a finetune task's model so)."""
    path = Path(path)
    device = next(state.model.parameters()).device
    payload = torch.load(path.with_suffix(".pt"), map_location=device, weights_only=True)
    model_sd, opt = local_state(state, payload["model"], None if model_only else payload["optimizer"])
    state.model.load_state_dict(model_sd)
    if not model_only:
        state.optimizer.load_state_dict(opt)
    state.step = int(payload["step"])
    sidecar = path.with_suffix(".json")
    return state, (json.loads(sidecar.read_text()) if sidecar.exists() else {})


def checkpoint_exists(path) -> bool:
    return Path(path).with_suffix(".pt").exists()


def save_params(path, model, *, mesh=None) -> None:
    """The model's parameters alone, ``{name: tensor}`` in ``<path>.pt`` (the JAX
    package's ``final_model_params.msgpack``), whole; every rank of ``mesh`` gathers,
    rank 0 writes."""
    params = whole_tensors(model, {name: p.detach() for name, p in model.named_parameters()})
    if is_main(mesh):
        path = Path(path).with_suffix(".pt")
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(params, path)
    barrier(mesh)


def restore_params(path, params_template: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The parameters ``save_params`` wrote to ``<path>.pt``, as ``{name: tensor}`` with
    the keys of ``params_template`` (a model's ``dict(named_parameters())`` or an earlier
    dump), each on its template tensor's device. Raises, as flax's ``from_bytes`` does
    against its template, on a key missing from the file or not in the template
    (``KeyError``) and on a shape that differs from the template's (``ValueError``)."""
    stored = torch.load(Path(path).with_suffix(".pt"), map_location="cpu", weights_only=True)
    missing, unexpected = sorted(set(params_template) - set(stored)), sorted(set(stored) - set(params_template))
    if missing or unexpected:
        raise KeyError(f"{path}: the parameters do not match the template: missing {missing}, unexpected {unexpected}")
    out = {}
    for name, like in params_template.items():
        value = stored[name]
        if tuple(value.shape) != tuple(like.shape):
            raise ValueError(f"{path}: {name} has shape {tuple(value.shape)}, the template {tuple(like.shape)}")
        out[name] = value.to(like.device)
    return out
