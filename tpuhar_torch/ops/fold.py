"""Fold ImageNet normalization into a patch-embed stem (``tpuhar/ops/fold.py``): the
``tpu_cnn`` stem or the ViT's tubelet ``proj``.

The stem is linear and every output sees a full patch, so with
``normalize(x) = x·s_c + o_c`` per input channel:

    W'[..., c, n] = W[..., c, n] · s_c
    δ[n]          = Σ_{taps, c} o_c · W[..., c, n]

and the offset lands in the next affine op: the ViT stem's bias (``b' = b + δ``), or
the ``tpu_cnn`` stem's BatchNorm (``μ' = μ − δ``). The folded model consumes raw
0..255 pixel values. The rewrite runs on the flax-layout variables (``bridge``), in
f32, before they are loaded and cast to the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .video import IMAGENET_MEAN, IMAGENET_STD


def _fold_kernel(kernel: np.ndarray, mean, std) -> Tuple[np.ndarray, np.ndarray]:
    """Scale a ``(..., 3, N)`` patch kernel; return ``(kernel', δ (N,))``."""
    std = np.asarray(std, np.float64)
    s = ((1.0 / 255.0) / std).astype(kernel.dtype)
    o = (-np.asarray(mean, np.float64) / std).astype(np.float32)
    taps_summed = kernel.astype(np.float32).reshape(-1, kernel.shape[-2], kernel.shape[-1]).sum(0)
    return kernel * s[:, None], o @ taps_summed


def fold_normalization(
    variables: Dict, config, *, mean=IMAGENET_MEAN, std=IMAGENET_STD
) -> Tuple[Dict, bool]:
    """Rewrite ``variables`` so the model consumes raw 0..255 pixels.

    Returns ``(new_variables, changed)``; ``changed=False`` (variables untouched)
    unless the tree holds a ViT tubelet stem or the backbone is a ``tpu_cnn`` patch
    stem. The input tree is not modified.
    """
    vit = variables.get("params", {}).get("video_encoder", {}).get("vit", {})
    if "tubelet" in vit:
        proj = vit["tubelet"]["proj"]
        kernel, delta = _fold_kernel(np.asarray(proj["kernel"]), mean, std)
        bias = np.asarray(proj["bias"])
        params = dict(variables["params"])
        params["video_encoder"] = dict(params["video_encoder"])
        params["video_encoder"]["vit"] = dict(vit, tubelet={"proj": {
            "kernel": kernel, "bias": (bias.astype(np.float32) + delta).astype(bias.dtype),
        }})
        return dict(variables, params=params), True
    if not config.model.video_backbone.startswith("tpu_cnn"):
        return variables, False
    backbone = variables.get("params", {}).get("video_encoder", {}).get("backbone", {})
    stats = variables.get("batch_stats", {}).get("video_encoder", {}).get("backbone", {})
    if "stem_conv" not in backbone or "stem_bn" not in stats:
        return variables, False

    kernel, delta = _fold_kernel(np.asarray(backbone["stem_conv"]["kernel"]), mean, std)
    stem_bn = stats["stem_bn"]
    new_mean = np.asarray(stem_bn["mean"]).astype(np.float32) - delta

    params = dict(variables["params"])
    params["video_encoder"] = dict(params["video_encoder"])
    params["video_encoder"]["backbone"] = dict(backbone, stem_conv={"kernel": kernel})
    batch_stats = dict(variables["batch_stats"])
    batch_stats["video_encoder"] = dict(batch_stats["video_encoder"])
    batch_stats["video_encoder"]["backbone"] = dict(
        stats, stem_bn={"mean": new_mean, "var": stem_bn["var"]}
    )
    return dict(variables, params=params, batch_stats=batch_stats), True
