"""The port's parameters in the JAX package's flax layout: load and initialise.

The port keeps its weights as the JAX package keeps them, a tree
``{"params": {...}, "batch_stats": {...}}`` nested by module name, with numpy arrays
as ``jax.device_get`` returns them. Each port module's attribute names are its flax
names, so the tree maps onto it by name:

- Dense ``kernel (in, out)`` → ``nn.Linear.weight (out, in)``; attention q/k/v
  ``DenseGeneral`` kernels ``(D, H, Dh)`` with bias ``(H, Dh)``, and ``out``
  ``(H, Dh, D)`` with bias ``(D,)``, flatten onto the same Linear layout;
- LayerNorm ``scale``/``bias`` → ``weight``/``bias``;
- everything else by its own name and shape: HWIO conv kernels (kept HWIO for the
  NHWC paths), the ViT's tubelet ``proj`` ``kernel (2, 16, 16, 3, D)``/``bias (D,)``,
  BatchNorm ``scale``/``bias``/``mean``/``var``, the IMU ``PatchEmbedding``
  ``kernel (C, P, D)``/``bias (C, 1, D)``, ``cls_token``, ``pos_encoding``.

``fold_normalization`` (``ops/fold.py``) rewrites the same tree. ``variables_to_numpy``
and ``grads_to_numpy`` take a model's tensors and gradients back to that layout. This
module imports no JAX.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# the JAX package's quantized tpu_cnn tree -> the port's (defined with the forwards)
from .ops.quant import quantized_tree_from_numpy  # noqa: F401

# torch parameter name → flax leaf name, where they differ
_FLAX_NAMES = {nn.Linear: {"weight": "kernel"}, nn.LayerNorm: {"weight": "scale"}}
# flax's lecun_normal: truncated at ±2σ, σ corrected for the truncation
_TRUNC_STD = 0.87962566103423978


def _flax_name(module: nn.Module, name: str) -> str:
    return _FLAX_NAMES.get(type(module), {}).get(name, name)


def _tensors(model: nn.Module) -> Iterator[Tuple[Tuple[str, ...], nn.Module, str, torch.Tensor, bool]]:
    """``(flax path, module, torch name, tensor, is_param)`` for every tensor."""
    for path, mod in model.named_modules():
        prefix = tuple(path.split(".")) if path else ()
        for (name, t), is_param in itertools.chain(
            ((p, True) for p in mod.named_parameters(recurse=False)),
            ((b, False) for b in mod.named_buffers(recurse=False)),
        ):
            yield prefix + (_flax_name(mod, name),), mod, name, t, is_param


def flax_shape(mod: nn.Module, name: str, t: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the flax leaf that the port's tensor ``name`` of ``mod`` holds: a
    Dense kernel ``(in, out)`` or a ``DenseGeneral``'s ``flax_shapes`` entry, a Dense
    bias ``(out,)`` or its ``flax_shapes`` entry, else the tensor's own shape."""
    if isinstance(mod, nn.Linear) and name in ("weight", "bias"):
        leaf = _flax_name(mod, name)
        default = (mod.in_features, mod.out_features) if name == "weight" else (mod.out_features,)
        return tuple(getattr(mod, "flax_shapes", {}).get(leaf, default))
    return tuple(t.shape)


def flax_parameters(model: nn.Module) -> Iterator[Tuple[str, str, nn.Module, str, torch.Tensor]]:
    """``(flax path "a/b/kernel", torch name "a.b.weight", module, the module's own name of
    it, tensor)`` for every parameter of ``model``."""
    for key, mod, name, t, is_param in _tensors(model):
        if is_param:
            yield "/".join(key), ".".join((*key[:-1], name)), mod, name, t


def _flatten(tree: Mapping, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


@torch.no_grad()
def load_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a flax-layout variable tree into ``model`` in place and return it.

    Raises ``KeyError`` when the tree lacks a tensor of the model or holds one the
    model does not have, and ``ValueError`` on a shape mismatch.
    """
    flat = dict(_flatten(variables.get("params", {})))
    flat.update(_flatten(variables.get("batch_stats", {})))
    targets = {key: (mod, name, t) for key, mod, name, t, _ in _tensors(model)}
    missing = sorted("/".join(k) for k in targets.keys() - flat.keys())
    unexpected = sorted("/".join(k) for k in flat.keys() - targets.keys())
    if missing or unexpected:
        raise KeyError(f"variables do not match the model: missing {missing}, unexpected {unexpected}")
    for key, (mod, name, t) in targets.items():
        value = np.array(flat[key], dtype=np.float32)  # a writable copy
        if isinstance(mod, nn.Linear):
            value = _linear_value(mod, name, value, key)
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{'/'.join(key)}: shape {value.shape} != {tuple(t.shape)}")
        t.copy_(torch.from_numpy(value.copy(order="C")))  # 0-d stays 0-d
    return model


def _linear_value(mod: nn.Linear, name: str, value: np.ndarray, key) -> np.ndarray:
    """A Dense/DenseGeneral leaf in ``nn.Linear`` layout: the kernel's leading axes
    must multiply to ``in_features`` and its trailing axes to ``out_features``."""
    if name == "bias":
        return value.reshape(-1) if value.size == mod.out_features else value
    for split in range(1, value.ndim):
        if (math.prod(value.shape[:split]), math.prod(value.shape[split:])) == (
            mod.in_features, mod.out_features,
        ):
            return value.reshape(mod.in_features, mod.out_features).T
    raise ValueError(
        f"{'/'.join(key)}: shape {value.shape} is no kernel of a "
        f"{mod.in_features} -> {mod.out_features} Dense"
    )


def _draw(mod: nn.Module, name: str, shape: Tuple[int, ...], generator: torch.Generator) -> np.ndarray:
    t = torch.empty(shape, dtype=torch.float32)
    if name in getattr(mod, "init_values", {}):  # a constant the module declares
        t.fill_(mod.init_values[name])
    elif name == "kernel":  # lecun_normal, fan_in = every axis but the output one
        std = math.sqrt(1.0 / math.prod(shape[:-1])) / _TRUNC_STD
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    elif name in ("cls_token", "pos_encoding"):  # normal, σ as the module declares it
        t.normal_(0.0, getattr(mod, "init_std", {}).get(name, 1.0), generator=generator)
    elif name in ("scale", "var"):
        t.fill_(1.0)
    elif name in ("bias", "mean"):
        t.fill_(0.0)
    else:
        raise KeyError(f"no initialiser for {name!r}")
    return t.numpy()


def init_params(config, generator: torch.Generator, model_cls: Optional[type] = None) -> Dict:
    """A fresh flax-layout variable tree for ``model_cls(config)`` (default
    ``FusionClassifier``; ``CrossModalModel`` for pretraining, ``IMUClassifier`` for
    IMU-only serving), drawn from ``generator``
    with flax's initialisers and in flax's leaf shapes: truncated lecun-normal kernels (a
    ``DenseGeneral``'s drawn as its ``(in, out)`` matrix, as flax draws it), zero biases,
    LayerNorm 1/0, ``cls_token``/``pos_encoding`` ~ N(0, σ) with the module's
    ``init_std`` (σ = 1 unless it says otherwise), BatchNorm scale/bias 1/0 and running
    stats 0/1, and the constants a module declares in ``init_values`` (the SigLIP
    ``temperature`` log 10 and ``bias`` −10). Values are f32 numpy arrays."""
    from .models.crossmodal import FusionClassifier

    with torch.device("meta"):  # shapes only; nothing is allocated
        model = (model_cls or FusionClassifier)(config, dtype=torch.float32)
    variables = {"params": {}, "batch_stats": {}}
    for key, mod, name, t, is_param in _tensors(model):
        shape = tuple(t.shape)
        if isinstance(mod, nn.Linear) and name == "weight":
            shape = (mod.in_features, mod.out_features)
        value = _draw(mod, key[-1], shape, generator)
        value = value.reshape(getattr(mod, "flax_shapes", {}).get(key[-1], value.shape))
        _put(variables["params" if is_param else "batch_stats"], key, value)
    return variables


def _to_flax(mod: nn.Module, name: str, leaf: str, value: np.ndarray) -> np.ndarray:
    """A tensor of the port in its flax leaf's layout: the inverse of ``load_variables``."""
    if isinstance(mod, nn.Linear) and name == "weight":
        value = value.T
    shape = getattr(mod, "flax_shapes", {}).get(leaf)
    return (value.reshape(shape) if shape else value).copy(order="C")


def variables_to_numpy(model: nn.Module) -> Dict:
    """The model's parameters and buffers as a flax-layout tree ``{"params": ...,
    "batch_stats": ...}`` of f32 numpy arrays (``load_variables`` reads it back)."""
    tree = {"params": {}, "batch_stats": {}}
    for key, mod, name, t, is_param in _tensors(model):
        value = _to_flax(mod, name, key[-1], t.detach().float().cpu().numpy())
        _put(tree["params" if is_param else "batch_stats"], key, value)
    return tree


def grads_to_numpy(model: nn.Module) -> Dict:
    """The parameters' ``.grad`` as a flax-layout params tree of f32 numpy arrays, as
    ``jax.grad`` gives it; a parameter without a gradient gives zeros."""
    tree = {}
    for key, mod, name, t, is_param in _tensors(model):
        if is_param:
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            _put(tree, key, _to_flax(mod, name, key[-1], g.detach().float().cpu().numpy()))
    return tree
