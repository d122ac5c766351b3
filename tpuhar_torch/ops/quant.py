"""Post-training int8 quantization of the ``tpu_cnn`` serving tower
(the TPUVideoCNN half of ``tpuhar/ops/quant.py``).

- symmetric per-output-channel weight quantization and per-tensor activation scales
  (absmax over calibration frames);
- ``int8_conv``, the plain int8 conv: the integer accumulator in float64 (exact for
  int8 × int8 sums of any length the tower has), then the f32 rescale, and
  ``quantize_activations`` (both live in ``ops/conv3x3``, under the int8 conv's plain
  version, and are re-exported here);
- ``calibrate_tpucnn``/``quantize_tpucnn``, which fold BatchNorm (and optionally the
  ImageNet normalization) and quantize every conv;
- the baseline forward (``quant_tpucnn_forward``, quantize at each conv's input) and
  the int8-resident forward (``quant_tpucnn_forward_resident``, the producer
  requantizes in its epilogue, so only int8 lies between the convs).

The arithmetic follows the JAX package op for op: ``fold_bn`` divides by
``sqrt(var + eps)``, ``quantize_activations`` divides by the scale, ``int8_conv``
multiplies ``x_scale · w_scale`` first, site scales divide a Python float by 127 before
the f32 cast. ``torch.round`` and ``jnp.round`` both round half to even.

The forwards take the tree of ``quantize_tpucnn`` or of ``quantized_tree_from_numpy``
(the JAX package's tree carried over; also ``bridge.quantized_tree_from_numpy``), which
holds each conv's packed int8 weights and its per-channel ``x_scale · w_scale`` next to
``w_q``/``w_scale``/``bias``. On a CUDA device the stem runs through ``ops/stem.stem_gemm_u8`` and every 3×3 conv through
``ops/conv3x3.conv3x3_i8``; frames must then arrive as the uint8 patch-major wire.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .conv3x3 import (  # noqa: F401 (int8_conv, quantize_activations: the plain primitives)
    conv3x3_i8,
    conv_nhwc,
    int8_conv,
    pack_conv3x3_i8,
    quantize_activations,
)
from .stem import pack_stem_u8, stem_gemm_u8


def quantize_weights(w: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization along ``axis``: ``w ≈ w_q · scale``,
    ``scale`` keeps ``w``'s rank (size 1 on the reduced axes)."""
    reduce_dims = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    absmax = w.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale.float()


def fold_bn(conv_kernel, bn_scale, bn_bias, bn_mean, bn_var, eps: float = 1e-5):
    """Fold inference BatchNorm into the conv before it: ``(kernel · g, bias − mean · g)``
    with ``g = scale / sqrt(var + eps)`` (a division, as the JAX package does; the
    fused bf16 conv's ``ops/conv3x3.fold_bn`` multiplies by ``rsqrt`` instead).

    The square root is taken in float64 and rounded to f32, which is the correctly
    rounded f32 root; PyTorch's vectorized f32 ``sqrt`` on the CPU is not always."""
    g = bn_scale / torch.sqrt((bn_var + eps).double()).float()
    return conv_kernel * g.reshape(1, 1, 1, -1), bn_bias - bn_mean * g


def _tpucnn_layout(params) -> Tuple[int, int]:
    """``(num_stages, blocks_per_stage)`` of a TPUVideoCNN parameter tree."""
    stages = 1
    while f"down{stages}_conv" in params:
        stages += 1
    blocks = 0
    while f"s0b{blocks}a_conv" in params:
        blocks += 1
    return stages, blocks


def _tensor(v, device, dtype=torch.float32) -> torch.Tensor:
    """A numpy or torch leaf as a ``dtype`` tensor on ``device``."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v))
    return v.to(device=device, dtype=dtype)


def _folded(params, batch_stats, prefix: str, device):
    return fold_bn(
        _tensor(params[f"{prefix}_conv"]["kernel"], device),
        _tensor(params[f"{prefix}_bn"]["scale"], device),
        _tensor(params[f"{prefix}_bn"]["bias"], device),
        _tensor(batch_stats[f"{prefix}_bn"]["mean"], device),
        _tensor(batch_stats[f"{prefix}_bn"]["var"], device),
    )


def _observed(stats: Dict[str, float], name: str, x: torch.Tensor) -> None:
    stats[name] = max(stats.get(name, 0.0), float(x.abs().max()))


@torch.inference_mode()
def calibrate_tpucnn(params, batch_stats, frames: torch.Tensor) -> Dict[str, float]:
    """Per-site absmax over calibration ``frames`` (NHWC f32) through the f32
    TPUVideoCNN at eval, with BatchNorm folded. Sites are the conv inputs."""
    device = frames.device
    stats: Dict[str, float] = {}
    stages, blocks = _tpucnn_layout(params)
    patch = int(params["stem_conv"]["kernel"].shape[0])

    def conv_bn(x, prefix, stride, padding):
        kernel, bias = _folded(params, batch_stats, prefix, device)
        return conv_nhwc(x, kernel, stride, padding) + bias

    x = frames.float()
    _observed(stats, "stem", x)
    x = torch.relu(conv_bn(x, "stem", patch, "VALID"))
    for si in range(stages):
        if si > 0:
            _observed(stats, f"down{si}.in", x)
            x = torch.relu(conv_bn(x, f"down{si}", 2, "SAME"))
        for bi in range(blocks):
            name = f"s{si}b{bi}"
            _observed(stats, f"{name}.in", x)
            h = torch.relu(conv_bn(x, f"{name}a", 1, "SAME"))
            _observed(stats, f"{name}.mid", h)
            x = torch.relu(conv_bn(h, f"{name}b", 1, "SAME") + x)
    return stats


def _conv_sites(stages: int, blocks: int) -> Dict[Tuple[str, ...], str]:
    """Tree path of every 3×3 conv → the activation site its input is quantized at."""
    sites = {}
    for si in range(stages):
        if si > 0:
            sites[(f"down{si}",)] = f"down{si}.in"
        for bi in range(blocks):
            sites[(f"s{si}b{bi}", "a")] = f"s{si}b{bi}.in"
            sites[(f"s{si}b{bi}", "b")] = f"s{si}b{bi}.mid"
    return sites


@torch.inference_mode()
def quantize_tpucnn(
    params, batch_stats, act_stats: Dict[str, float], *, input_fold=None, device="cpu"
) -> Dict:
    """Fold BatchNorm and quantize every TPUVideoCNN conv per output channel.

    ``input_fold=(mean, std)`` also folds the ImageNet normalization into the stem,
    so that it consumes raw uint8 pixels as ``clip(u8 − 128, −127, 127)``:
    ``(u8/255 − m)/s = (u8 − 128)·a + c`` with ``a = 1/(255·s)`` scaling the stem
    kernel's input channels and ``c = (128/255 − m)/s`` landing in its bias. Returns
    the forwards' tree (``quantized_tree_from_numpy``) on ``device``.
    """
    stages, blocks = _tpucnn_layout(params)

    def site_scale(name):
        return np.float32(max(act_stats.get(name, 1.0), 1e-6) / 127.0)

    def pack(prefix):
        kernel, bias = _folded(params, batch_stats, prefix, device)
        if prefix == "stem" and input_fold is not None:
            mean, std = (torch.tensor(v, dtype=torch.float32, device=device) for v in input_fold)
            a = 1.0 / (255.0 * std)
            c = (128.0 / 255.0 - mean) / std
            taps_summed = kernel.reshape(-1, kernel.shape[-2], kernel.shape[-1]).sum(0)
            bias = bias + c @ taps_summed  # the offset, before the kernel is rescaled
            kernel = kernel * a[:, None]
        w_q, w_s = quantize_weights(kernel, axis=-1)
        return {"w_q": w_q, "w_scale": w_s.reshape(-1), "bias": bias}

    q: Dict = {
        "act_scales": {k: site_scale(k) for k in act_stats},
        "layout": (stages, blocks),
        "patch": int(params["stem_conv"]["kernel"].shape[0]),
        "input_fold": input_fold is not None,
        "stem": pack("stem"),
    }
    for si in range(stages):
        if si > 0:
            q[f"down{si}"] = pack(f"down{si}")
        for bi in range(blocks):
            name = f"s{si}b{bi}"
            q[name] = {"a": pack(f"{name}a"), "b": pack(f"{name}b")}
    return quantized_tree_from_numpy(q, device)


def quantized_tree_from_numpy(q: Dict, device="cpu") -> Dict:
    """The quantized tree in the JAX package's form (numpy or torch leaves) → the
    forwards' tree on ``device``.

    Each conv keeps ``w_q`` (int8 HWIO), ``w_scale`` and ``bias`` (f32) and gains
    what its kernel takes, made once here: ``w_packed`` (the int8 GEMM matrix, K-major
    as int8 ``wgmma`` reads it: ``(C0, p²·3)`` for the stem, ``pack_stem_u8``, and
    ``(C_out, 9·C)`` for a 3×3 conv, ``pack_conv3x3_i8``) and, for 3×3 convs,
    ``x_scale`` (its input site's scale, a 0-d f32 tensor on ``device``) and ``xs_ws``
    (``x_scale · w_scale`` in f32, the rescale ``int8_conv`` applies). Site scales
    become Python floats that hold the exact f32 values.
    """
    stages, blocks = (int(v) for v in q["layout"])
    scales = {k: float(np.float32(v)) for k, v in q["act_scales"].items()}

    def leaves(entry):
        return {
            "w_q": _tensor(entry["w_q"], device, torch.int8).contiguous(),
            "w_scale": _tensor(entry["w_scale"], device).reshape(-1).contiguous(),
            "bias": _tensor(entry["bias"], device).reshape(-1).contiguous(),
        }

    stem = leaves(q["stem"])
    stem["w_packed"] = pack_stem_u8(stem["w_q"])
    out: Dict = {
        "act_scales": scales,
        "layout": (stages, blocks),
        "patch": int(q["patch"]),
        "input_fold": bool(q["input_fold"]),
        "stem": stem,
    }
    for path, site in _conv_sites(stages, blocks).items():
        entry = q[path[0]] if len(path) == 1 else q[path[0]][path[1]]
        conv = leaves(entry)
        conv["w_packed"] = pack_conv3x3_i8(conv["w_q"])
        conv["x_scale"] = torch.tensor(scales[site], dtype=torch.float32, device=device)
        conv["xs_ws"] = (conv["x_scale"] * conv["w_scale"]).contiguous()
        if len(path) == 1:
            out[path[0]] = conv
        else:
            out.setdefault(path[0], {})[path[1]] = conv
    return out


def tree_to(q: Dict, device) -> Dict:
    """A copy of a forwards' tree with every tensor on ``device``."""
    if isinstance(q, dict):
        return {k: tree_to(v, device) for k, v in q.items()}
    return q.to(device) if isinstance(q, torch.Tensor) else q


def _is_patch_major(q: Dict, frames: torch.Tensor) -> bool:
    """True for the serving wire ``(N, H/p, W/p, p²·3)``, False for NHWC."""
    p = q["patch"]
    return frames.dim() == 4 and frames.shape[-1] == p * p * 3


def _stem_patch_major(q: Dict, col_u8: torch.Tensor, *, out_scale: Optional[float] = None):
    """The uint8 patch-major stem: byte map, K = p²·3 int8 GEMM, ×scale + bias, ReLU,
    and with ``out_scale`` the requant to int8 (bit-exact vs ``quantize_activations``)."""
    if not q["input_fold"]:
        raise ValueError(
            "patch-major frames need a tree built with input_fold (the stem must "
            "consume raw uint8)"
        )
    stem = q["stem"]
    return stem_gemm_u8(
        col_u8, stem["w_packed"], stem["w_scale"], stem["bias"], relu=True, out_scale=out_scale
    )


def _stem_nhwc(q: Dict, frames: torch.Tensor) -> torch.Tensor:
    """The stem on NHWC frames (raw uint8 with ``input_fold``, else normalized f32):
    a plain int8 conv, on the CPU only."""
    if frames.device.type != "cpu":
        raise ValueError(
            "NHWC frames on a CUDA device: the int8 tower's card path takes the uint8 "
            "patch-major wire only (ops/stem.to_patch_major)"
        )
    p, stem = q["patch"], q["stem"]
    if q["input_fold"]:
        x_q = torch.clamp(frames.to(torch.int16) - 128, -127, 127).to(torch.int8)
        y = int8_conv(x_q, stem["w_q"], 1.0, stem["w_scale"], stride=p, padding="VALID")
    else:
        xs = torch.tensor(q["act_scales"]["stem"], dtype=torch.float32)
        y = int8_conv(
            quantize_activations(frames, xs), stem["w_q"], xs, stem["w_scale"],
            stride=p, padding="VALID",
        )
    return torch.relu(y + stem["bias"])


def _conv(x_q, conv, *, stride=1, residual=None, res_scale=None, relu=True, out_scale=None):
    return conv3x3_i8(
        x_q, conv["w_packed"], conv["xs_ws"], conv["bias"], stride=stride,
        residual=residual, res_scale=res_scale, relu=relu, out_scale=out_scale,
    )


@torch.inference_mode()
def quant_tpucnn_forward(q: Dict, frames: torch.Tensor) -> torch.Tensor:
    """int8 TPUVideoCNN features ``(N, widths[-1])`` f32, quantizing at each conv's
    input (the consumer side); the activations between convs are f32.

    ``frames`` is the patch-major uint8 wire ``(N, H/p, W/p, p²·3)`` (needs
    ``input_fold``), or on the CPU NHWC ``(N, H, W, 3)``: raw uint8 with
    ``input_fold``, normalized f32 without."""
    stages, blocks = q["layout"]

    def qconv(x, conv, *, stride=1, relu):
        return _conv(quantize_activations(x, conv["x_scale"]), conv, stride=stride, relu=relu)

    x = _stem_patch_major(q, frames) if _is_patch_major(q, frames) else _stem_nhwc(q, frames)
    for si in range(stages):
        if si > 0:
            x = qconv(x, q[f"down{si}"], stride=2, relu=True)
        for bi in range(blocks):
            name = f"s{si}b{bi}"
            h = qconv(x, q[name]["a"], relu=True)
            h = qconv(h, q[name]["b"], relu=False)
            x = torch.relu(h + x)
    return x.mean(dim=(1, 2))


@torch.inference_mode()
def quant_tpucnn_forward_resident(q: Dict, frames: torch.Tensor) -> torch.Tensor:
    """int8-resident TPUVideoCNN features: every producer requantizes in its epilogue
    at the site of its consumers, so only int8 tensors lie between the convs.

    Same tree and the same conv inputs as ``quant_tpucnn_forward`` through the first
    block; the skip add reads ``x_q · scale[site]`` (``relu(o + deq)``) instead of
    the f32 activation. The last block's output stays f32 for the pooled mean.
    ``frames`` as in ``quant_tpucnn_forward``."""
    scales = q["act_scales"]
    stages, blocks = q["layout"]

    def next_site(si, bi):
        if bi + 1 < blocks:
            return f"s{si}b{bi + 1}.in"
        if si + 1 < stages:
            return f"down{si + 1}.in"
        return None  # the last block feeds the f32 pooled mean

    site = "s0b0.in"
    if _is_patch_major(q, frames):
        x_q = _stem_patch_major(q, frames, out_scale=scales[site])
    else:
        x_q = quantize_activations(_stem_nhwc(q, frames), scales[site])
    for si in range(stages):
        if si > 0:
            site = f"s{si}b0.in"
            x_q = _conv(x_q, q[f"down{si}"], stride=2, relu=True, out_scale=scales[site])
        for bi in range(blocks):
            name = f"s{si}b{bi}"
            h_q = _conv(x_q, q[name]["a"], relu=True, out_scale=scales[f"{name}.mid"])
            nxt = next_site(si, bi)
            y = _conv(
                h_q, q[name]["b"], residual=x_q, res_scale=scales[site], relu=True,
                out_scale=None if nxt is None else scales[nxt],
            )
            if nxt is not None:
                site, x_q = nxt, y
    return y.mean(dim=(1, 2))
