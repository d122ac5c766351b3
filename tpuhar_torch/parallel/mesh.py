"""The device mesh and the placement of batches and state on it (``tpuhar/parallel/
mesh.py``), data parallel.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape ``(world // tp,
tp)`` over the process group, its dims ``("data", "model")``. Each rank holds a full
copy of the parameters, the optimizer state and the batch statistics, equal on every
rank (``shard_state``), and its rows of each batch (``shard_batch``); the steps
(``train/steps``, under ``parallel.scope``) compute the one-device step on the global
batch and sum the gradients over the ranks, the serving engine gathers its ranks'
outputs. Checkpoints are mesh-independent (no ``module.`` prefix: no DDP wrapper).

Tensor parallelism over ``"model"`` (``model_axis_size > 1``: ``tp_rules``,
``partition_specs``, ``shard_params``) is ROADMAP item 8f: ``maybe_mesh`` raises for it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .scope import DataShard

TP_NOT_PORTED = "tensor parallelism over the 'model' axis (model_axis_size > 1) is not ported: ROADMAP item 8f"


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(*, model_axis_size: int = 1, data_axis: str = "data", model_axis: str = "model"):
    """A ``DeviceMesh`` of shape ``(world // model_axis_size, model_axis_size)`` over the
    process group (which must be up), dims ``(data_axis, model_axis)``; on CUDA for an
    NCCL group, else on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if world % model_axis_size != 0:
        raise ValueError(f"{world} processes not divisible by model_axis_size={model_axis_size}")
    return init_device_mesh(_device_type(), (world // model_axis_size, model_axis_size),
                            mesh_dim_names=(data_axis, model_axis))


def maybe_mesh(config=None):
    """The training and serving mesh, or None: with ``training.data_parallel`` off, or
    in a world of one process (no group, or a group of one). ``training.model_axis_size``
    > 1 raises ``NotImplementedError`` (ROADMAP item 8f)."""
    t = getattr(config, "training", None)
    if t is not None and not bool(getattr(t, "data_parallel", True)):
        return None
    if t is not None and max(int(getattr(t, "model_axis_size", 1) or 1), 1) > 1:
        raise NotImplementedError(TP_NOT_PORTED)
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < 2:
        return None
    return create_mesh(data_axis=getattr(t, "data_axis", "data") if t else "data",
                       model_axis=getattr(t, "model_axis", "model") if t else "model")


def data_shard(mesh, data_axis: Optional[str] = None) -> DataShard:
    """This rank's place on ``mesh``'s data axis (its first dim by default)."""
    axis = data_axis or mesh.mesh_dim_names[0]
    return DataShard(mesh.get_local_rank(axis), mesh[axis].size(), mesh.get_group(axis))


def is_main(mesh=None) -> bool:
    """True on the process that writes files: rank 0, or the only process."""
    return mesh is None or dist.get_rank() == 0


def barrier(mesh=None) -> None:
    """Wait for every rank of ``mesh`` (nothing without one)."""
    if mesh is not None:
        dist.barrier()


def agree(value, mesh=None):
    """Rank 0's ``value`` (any picklable object) on every rank of ``mesh``; ``value``
    itself without one."""
    if mesh is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class ShardedBatch(dict):
    """A batch placed on a mesh: each rank's rows where ``shard`` is set; whole (a
    replicated batch) where no array's rows divide over the data axis."""

    shard: Optional[DataShard] = None


def shard_batch(batch: Dict, mesh, data_axis: Optional[str] = None) -> ShardedBatch:
    """This rank's rows of every array (tensor or numpy) whose leading axis divides over
    the data axis; everything else whole. A batch already placed is returned as it is."""
    if isinstance(batch, ShardedBatch):
        return batch
    shard = data_shard(mesh, data_axis)
    out, split = ShardedBatch(), False
    for key, value in batch.items():
        if isinstance(value, (torch.Tensor, np.ndarray)) and value.ndim >= 1 and value.shape[0] % shard.size == 0:
            value = value[shard.rows(value.shape[0] // shard.size)]
            split = True
        out[key] = value
    out.shard = shard if split else None
    return out


def shard_state(state, mesh):
    """``state`` (a ``train.steps.TrainState``) with every parameter, buffer and optimizer
    moment broadcast from the data axis's rank 0, so that every rank starts equal."""
    shard = data_shard(mesh)
    src = dist.get_global_rank(shard.group, 0)
    with torch.no_grad():
        tensors = [*state.model.state_dict().values(), *state.optimizer.mu, *state.optimizer.nu]
        for t in tensors:
            dist.broadcast(t, src=src, group=shard.group)
        meta = [state.step, state.optimizer.count]
        dist.broadcast_object_list(meta, src=src, group=shard.group)
        state.step, state.optimizer.count = int(meta[0]), int(meta[1])
    return state
