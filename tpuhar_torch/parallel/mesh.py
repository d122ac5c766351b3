"""The device mesh and the placement of batches and state on it (``tpuhar/parallel/
mesh.py``): data parallel over ``"data"``, tensor parallel over ``"model"``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape ``(world // tp,
tp)`` over the process group, its dims ``("data", "model")``: rank ``k`` is data index
``k // tp`` and model index ``k % tp``, JAX's ``reshape(n // tp, tp)`` of its devices.
Each rank holds its rows of each batch (``shard_batch``) and, over the model axis, its
shard of the parameters and their AdamW moments (``shard_state``): the TP rules
(``tp_rules``, the JAX package's regexes over flax's ``/``-joined paths) split the
attention heads and the MLP hidden units of the IMU, ViT and fusion blocks
column-parallel in and row-parallel out, Megatron-style; everything else, the buffers and
BatchNorm statistics included, is replicated. A leaf whose split dimension does not
divide stays whole, as JAX's fallback gives. The steps (``train/steps``, under
``parallel.scope``) compute the one-device step on the global batch: the split blocks
issue their collectives over the model group themselves (``scope.copy_to_model``,
``scope.row_parallel``) where GSPMD inserts JAX's, and the gradients are summed over the
data group. The serving engine serves whole parameters and splits its rows over the data
axis only, as JAX's does.

Checkpoints are mesh-independent: ``whole_state`` gathers the model group's shards (a
collective every rank enters), ``local_state`` takes a rank's shard of whole tensors. No ``module.`` prefix: no DDP wrapper.

Departure: JAX trims its device list to a multiple of the TP degree; the port has
processes, not a device list, and raises ``ValueError`` where the world does not divide.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..bridge import flax_parameters, flax_shape
from .scope import DataShard, ModelShard


class P(tuple):
    """A partition spec: one mesh-axis name (or None) per dimension of a flax leaf, as
    ``jax.sharding.PartitionSpec`` holds them; ``P()`` is replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def tp_rules(model_axis: str = "model"):
    """``(path regex, spec)`` pairs over flax's ``/``-joined parameter paths (the JAX
    package's rules): Dense kernels are ``(in, out)``, attention kernels ``(D, H, Dh)``
    for q/k/v and ``(H, Dh, D)`` for ``out``."""
    return [
        # ViT / fusion MLPs: column-parallel in, row-parallel out
        (re.compile(r".*mlp_in/kernel$"), P(None, model_axis)),
        (re.compile(r".*mlp_in/bias$"), P(model_axis)),
        (re.compile(r".*mlp_out/kernel$"), P(model_axis, None)),
        # torch-style transformer blocks (IMU encoder)
        (re.compile(r".*linear1/kernel$"), P(None, model_axis)),
        (re.compile(r".*linear1/bias$"), P(model_axis)),
        (re.compile(r".*linear2/kernel$"), P(model_axis, None)),
        # attention: shard heads
        (re.compile(r".*attn/(query|key|value)/kernel$"), P(None, model_axis, None)),
        (re.compile(r".*attn/(query|key|value)/bias$"), P(model_axis, None)),
        (re.compile(r".*attn/out/kernel$"), P(model_axis, None, None)),
    ]


def spec_for_path(path: str, rules) -> P:
    for pattern, spec in rules:
        if pattern.match(path):
            return spec
    return P()  # replicated


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _axis_size(mesh, axis: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))[axis]


def create_mesh(*, model_axis_size: int = 1, data_axis: str = "data", model_axis: str = "model"):
    """A ``DeviceMesh`` of shape ``(world // model_axis_size, model_axis_size)`` over the
    process group (which must be up), dims ``(data_axis, model_axis)``; on CUDA for an
    NCCL group, else on the CPU (a gloo group's collectives also take CUDA tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if world % model_axis_size != 0:
        raise ValueError(f"{world} processes not divisible by model_axis_size={model_axis_size}")
    return init_device_mesh(_device_type(), (world // model_axis_size, model_axis_size),
                            mesh_dim_names=(data_axis, model_axis))


def maybe_mesh(config=None):
    """The training and serving mesh, or None: with ``training.data_parallel`` off, or
    in a world of one process (no group, or a group of one) at a model axis of 1.
    ``training.model_axis_size`` is the TP degree; a world smaller than it raises JAX's
    ``ValueError``, a world it does not divide the ``create_mesh`` one."""
    t = getattr(config, "training", None)
    if t is not None and not bool(getattr(t, "data_parallel", True)):
        return None
    model_axis_size = max(int(getattr(t, "model_axis_size", 1) or 1), 1) if t is not None else 1
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if world < 2 and model_axis_size <= 1:
        return None
    if world < model_axis_size:
        raise ValueError(f"model_axis_size={model_axis_size} needs at least that many devices; have {world}")
    return create_mesh(model_axis_size=model_axis_size,
                       data_axis=getattr(t, "data_axis", "data") if t is not None else "data",
                       model_axis=getattr(t, "model_axis", "model") if t is not None else "model")


def data_shard(mesh, data_axis: Optional[str] = None) -> DataShard:
    """This rank's place on ``mesh``'s data axis (its first dim by default)."""
    axis = data_axis or mesh.mesh_dim_names[0]
    return DataShard(mesh.get_local_rank(axis), mesh[axis].size(), mesh.get_group(axis))


def model_shard(mesh, model_axis: Optional[str] = None) -> ModelShard:
    """This rank's place on ``mesh``'s model axis (its second dim by default)."""
    axis = model_axis or mesh.mesh_dim_names[1]
    return ModelShard(mesh.get_local_rank(axis), mesh[axis].size(), mesh.get_group(axis))


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
    replicated batch) where no array's rows divide over the data axis, or the axis is
    one rank."""

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
    out.shard = shard if split and shard.size > 1 else None
    return out


# -- tensor parallelism over the model axis ---------------------------------------------
def partition_specs(model: torch.nn.Module, mesh, model_axis: str = "model") -> Dict[str, P]:
    """``{flax path: spec}`` of every parameter of the whole ``model`` under the TP
    rules, its flax path and leaf shape through ``bridge``'s naming. A spec whose split
    dimension does not divide by the model axis falls back to replication, and every
    spec is ``P()`` at a model axis of 1 (JAX's ``partition_specs``)."""
    rules, size = tp_rules(model_axis), _axis_size(mesh, model_axis)
    specs = {}
    for path, _, mod, name, t in flax_parameters(model):
        spec, shape = spec_for_path(path, rules), flax_shape(mod, name, t)
        if size == 1 or any(axis is not None and (dim >= len(shape) or shape[dim] % size)
                            for dim, axis in enumerate(spec)):
            spec = P()
        specs[path] = spec
    return specs


def _split_dim(mod: torch.nn.Module, name: str, shape, spec: P) -> int:
    """The dimension of the port's tensor that ``spec`` splits on its flax leaf of
    ``shape``. A Dense kernel is the transpose of the torch weight and a ``DenseGeneral``
    kernel flattens onto it: an axis among the kernel's input axes splits the weight's
    columns, one among its output axes its rows, each in contiguous blocks where the axis
    leads its group (q/k/v ``(D, H, Dh)``: rows; ``out`` ``(H, Dh, D)``: columns)."""
    axis = next(dim for dim, a in enumerate(spec) if a is not None)
    if isinstance(mod, torch.nn.Linear) and name == "weight":
        inputs = next(s for s in range(1, len(shape) + 1) if int(np.prod(shape[:s])) == mod.in_features)
        if axis not in (0, inputs):
            raise ValueError(f"spec {spec} on a {shape} kernel splits no contiguous block of the weight")
        return 1 if axis == 0 else 0
    if isinstance(mod, torch.nn.Linear) and axis != 0:
        raise ValueError(f"spec {spec} on a {shape} bias splits no contiguous block of it")
    return axis


def shard_params(model: torch.nn.Module, mesh, model_axis: str = "model") -> torch.nn.Module:
    """Turn the whole ``model``'s parameters into this rank's shard on the model axis, in
    place: each parameter the rules split keeps its rank's block (model rank ``r``
    holds exactly what JAX places on its device at model position ``r``), the Linears'
    features and flax leaf shapes follow, and every split attention and MLP learns its
    ``ModelShard`` (``split_over_model``), so that its forward issues the collectives.
    ``model.tp_dims`` maps each split parameter's name to its split dimension. Nothing
    changes at a model axis of 1, or on a model already split."""
    shard = model_shard(mesh, model_axis)
    if shard.size == 1 or hasattr(model, "tp_dims"):
        return model
    specs = partition_specs(model, mesh, model_axis)
    split = [(qualified, mod, name, t, flax_shape(mod, name, t), specs[path])
             for path, qualified, mod, name, t in flax_parameters(model)
             if any(a is not None for a in specs[path])]
    dims = {}
    with torch.no_grad():
        for qualified, mod, name, t, shape, spec in split:
            dim = _split_dim(mod, name, shape, spec)
            n = t.shape[dim] // shard.size
            t.data = t.data.narrow(dim, shard.rank * n, n).clone()
            dims[qualified] = dim
            if isinstance(mod, torch.nn.Linear):
                mod.out_features, mod.in_features = mod.weight.shape
                if "flax_shapes" in vars(mod):
                    axis = next(d for d, a in enumerate(spec) if a is not None)
                    leaf = "kernel" if name == "weight" else name
                    local = tuple(s // shard.size if d == axis else s for d, s in enumerate(shape))
                    mod.flax_shapes = {**mod.flax_shapes, leaf: local}
    for mod in model.modules():
        if hasattr(mod, "split_over_model"):
            mod.split_over_model(shard)
    model.tp_dims, model.model_shard = dims, shard
    return model


def _moment_dims(state) -> List[Optional[int]]:
    """The split dimension of each AdamW moment: its parameter's (co-sharded)."""
    dims = getattr(state.model, "tp_dims", {})
    by_param = {id(p): dims.get(name) for name, p in state.model.named_parameters()}
    return [by_param[id(p)] for p in state.optimizer.trained]


def _local(t: torch.Tensor, dim: Optional[int], shard: ModelShard) -> torch.Tensor:
    """This rank's block of the whole ``t`` along ``dim`` (``t`` itself where None)."""
    if dim is None:
        return t
    n = t.shape[dim] // shard.size
    return t.narrow(dim, shard.rank * n, n).contiguous()


def _whole(tensors: List[torch.Tensor], dims: List[Optional[int]], shard: ModelShard) -> List[torch.Tensor]:
    """The whole tensors of the model group's shards: each split tensor placed in its
    rank's block of zeros and the blocks summed over the group, one all-reduce per
    dtype (exact: every element is one rank's value plus zeros). Every rank of the
    group must call it."""
    out = list(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, (t, dim) in enumerate(zip(tensors, dims)):
        if dim is not None:
            by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        flat = torch.zeros(sum(tensors[i].numel() for i in idx) * shard.size, dtype=dtype,
                           device=tensors[idx[0]].device)
        start = 0
        for i in idx:
            t, dim = tensors[i].detach(), dims[i]
            shape = list(t.shape)
            shape[dim] *= shard.size
            out[i] = flat[start:start + t.numel() * shard.size].view(shape)
            out[i].narrow(dim, shard.rank * t.shape[dim], t.shape[dim]).copy_(t)
            start += t.numel() * shard.size
        dist.all_reduce(flat, group=shard.group)
    return out


def whole_tensors(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of ``model``'s parameters (or their gradients) with every split
    one gathered whole over the model group; as it is on a model that is not split.
    Every rank of the group must call it."""
    dims = getattr(model, "tp_dims", None)
    if not dims:
        return dict(tensors)
    names = list(tensors)
    whole = _whole([tensors[n] for n in names], [dims.get(n) for n in names], model.model_shard)
    return dict(zip(names, whole))


def whole_state(state):
    """``(model state dict, optimizer state dict)`` of ``state`` with every split
    parameter and moment gathered whole over the model group: what a run without a mesh
    holds. Every rank must call it (each gathers within its own model group)."""
    model_sd = whole_tensors(state.model, state.model.state_dict())
    opt = state.optimizer.state_dict()
    shard = getattr(state.model, "model_shard", None)
    if shard is not None:
        dims = _moment_dims(state)
        opt = {**opt, "mu": _whole(opt["mu"], dims, shard), "nu": _whole(opt["nu"], dims, shard)}
    return model_sd, opt


def local_state(state, model_sd: Dict[str, torch.Tensor], opt: Optional[Dict] = None):
    """The inverse of ``whole_state``: this rank's shard of whole tensors, for ``state``'s
    (split or whole) model and optimizer. ``opt`` may be None."""
    shard = getattr(state.model, "model_shard", None)
    if shard is None:
        return model_sd, opt
    dims = state.model.tp_dims
    model_sd = {name: _local(t, dims.get(name), shard) for name, t in model_sd.items()}
    if opt is not None:
        mdims = _moment_dims(state)
        opt = {**opt, "mu": [_local(t, d, shard) for t, d in zip(opt["mu"], mdims)],
               "nu": [_local(t, d, shard) for t, d in zip(opt["nu"], mdims)]}
    return model_sd, opt


def shard_state(state, mesh):
    """``state`` (a ``train.steps.TrainState``) placed on ``mesh``, in place: over the
    model axis its model's parameters and their AdamW moments split by the TP rules
    (``shard_params``; the moments co-sharded, as JAX's suffix match gives; the buffers
    and BatchNorm statistics replicated); then every parameter, buffer and moment
    broadcast from the data axis's rank 0 within each model column, so that the data
    ranks start equal. A state already split is only broadcast."""
    shard = model_shard(mesh)
    if shard.size > 1 and not hasattr(state.model, "tp_dims"):
        shard_params(state.model, mesh)
        opt = state.optimizer
        dims = _moment_dims(state)
        opt.mu = [_local(t, d, shard) for t, d in zip(opt.mu, dims)]
        opt.nu = [_local(t, d, shard) for t, d in zip(opt.nu, dims)]
    if shard.size > 1:
        split = {id(p) for name, p in state.model.named_parameters() if name in state.model.tp_dims}
        state.optimizer.split_over_model(shard, [id(p) in split for p in state.optimizer.params])
    data = data_shard(mesh)
    if data.size == 1:
        return state
    src = dist.get_global_rank(data.group, 0)
    with torch.no_grad():
        tensors = [*state.model.state_dict().values(), *state.optimizer.mu, *state.optimizer.nu]
        for t in tensors:
            dist.broadcast(t, src=src, group=data.group)
        meta = [state.step, state.optimizer.count]
        dist.broadcast_object_list(meta, src=src, group=data.group)
        state.step, state.optimizer.count = int(meta[0]), int(meta[1])
    return state
