"""Post-training int8 quantization of the serving towers (``tpuhar/ops/quant.py``):
the ``tpu_cnn`` tower and ResNet-18 here, the ViT in ``ops/quant_vit.py``.

- symmetric per-output-channel weight quantization and per-tensor activation scales
  (absmax over calibration frames);
- ``int8_conv`` and ``int8_dense``, the plain int8 conv and product: the integer
  accumulator in float64 (exact for int8 × int8 sums of any length the towers have),
  then the f32 rescale, and ``quantize_activations`` (``int8_conv`` and
  ``quantize_activations`` live in ``ops/conv3x3``, under the int8 conv's plain version,
  and are re-exported here);
- ``calibrate_tpucnn``/``quantize_tpucnn`` and ``calibrate_resnet18``/
  ``quantize_resnet18``, which fold BatchNorm (and for ``tpu_cnn`` optionally the
  ImageNet normalization) and quantize every conv;
- for each tower the baseline forward (``quant_tpucnn_forward``,
  ``quant_resnet18_forward``: quantize at each conv's input) and the int8-resident
  forward (``..._resident``: the producer requantizes in its epilogue, so only int8 lies
  between the convs, but where a downsample's f32 output is a block's skip).

The arithmetic follows the JAX package op for op: ``fold_bn`` divides by
``sqrt(var + eps)``, ``quantize_activations`` divides by the scale, ``int8_conv``
multiplies ``x_scale · w_scale`` first, site scales divide a Python float by 127 before
the f32 cast. ``torch.round`` and ``jnp.round`` both round half to even.

The forwards take the tree of ``quantize_tpucnn``/``quantize_resnet18`` or of
``quantized_tree_from_numpy`` (the JAX package's tree carried over; also
``bridge.quantized_tree_from_numpy``), which holds each conv's packed int8 weights, its
input site's scale and its per-channel ``x_scale · w_scale`` next to
``w_q``/``w_scale``/``bias``. On a CUDA device the ``tpu_cnn`` stem runs through
``ops/stem.stem_gemm_u8`` (frames must then arrive patch-major: the uint8 wire or
the centered int8 wire),
ResNet-18's 7×7 stem (on its im2col rows) and 1×1 downsample convs through
``ops/stem.int8_gemm``, and every 3×3 conv through ``ops/conv3x3.conv3x3_i8``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .conv3x3 import (  # noqa: F401 (int8_conv, quantize_activations: the plain primitives)
    conv3x3_i8,
    conv_nhwc,
    int8_conv,
    pack_conv3x3_i8,
    quantize_activations,
)
from .conv3x3 import max_pool_nhwc
from .stem import int8_gemm, pack_stem_u8, stem_gemm_u8


def quantize_weights(w: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization along ``axis``: ``w ≈ w_q · scale``,
    ``scale`` keeps ``w``'s rank (size 1 on the reduced axes)."""
    reduce_dims = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    absmax = w.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale.float()


def int8_dense(x_q, w_q, x_scale, w_scale):
    """Plain int8 product ``(..., K) @ (K, N)``, rescaled to f32: ``acc · (x_scale ·
    w_scale)``. The accumulator is float64, exact for every K of the towers (|acc| ≤
    3072·127² < 2⁵³), rounded to f32 as XLA's int32 → f32 convert rounds."""
    acc = (x_q.double() @ w_q.double()).float()
    return acc * (x_scale * w_scale.reshape(-1).float())


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
    forwards' tree on ``device``. The three forms are told apart by their keys: a
    ``tpu_cnn`` tree holds ``"layout"``, a ViT tree ``"depth"`` and ``"tubelet"``
    (``ops/quant_vit.vit_tree_from_numpy``), a ResNet-18 tree ``"layer0_0"``
    (``resnet18_tree_from_numpy``).

    In a ``tpu_cnn`` tree each conv keeps ``w_q`` (int8 HWIO), ``w_scale`` and ``bias`` (f32) and gains
    what its kernel takes, made once here: ``w_packed`` (the int8 GEMM matrix, K-major
    as int8 ``wgmma`` reads it: ``(C0, p²·3)`` for the stem, ``pack_stem_u8``, and
    ``(C_out, 9·C)`` for a 3×3 conv, ``pack_conv3x3_i8``) and, for 3×3 convs,
    ``x_scale`` (its input site's scale, a 0-d f32 tensor on ``device``) and ``xs_ws``
    (``x_scale · w_scale`` in f32, the rescale ``int8_conv`` applies). Site scales
    become Python floats that hold the exact f32 values.
    """
    if "depth" in q and "tubelet" in q:
        from .quant_vit import vit_tree_from_numpy

        return vit_tree_from_numpy(q, device)
    if "layer0_0" in q:
        return resnet18_tree_from_numpy(q, device)
    if "layout" not in q:
        raise ValueError(f"not a quantized tpu_cnn, ViT or ResNet-18 tree: keys {sorted(q)}")
    stages, blocks = (int(v) for v in q["layout"])
    scales = {k: float(np.float32(v)) for k, v in q["act_scales"].items()}

    stem = _leaves(q["stem"], device)
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
        conv = with_site(_leaves(entry, device), scales[site], device)
        conv["w_packed"] = pack_conv3x3_i8(conv["w_q"])
        if len(path) == 1:
            out[path[0]] = conv
        else:
            out.setdefault(path[0], {})[path[1]] = conv
    return out


def _leaves(entry, device) -> Dict:
    """A packed conv or dense layer's ``w_q`` (int8), ``w_scale`` and ``bias`` (f32)."""
    return {
        "w_q": _tensor(entry["w_q"], device, torch.int8).contiguous(),
        "w_scale": _tensor(entry["w_scale"], device).reshape(-1).contiguous(),
        "bias": _tensor(entry["bias"], device).reshape(-1).contiguous(),
    }


def with_site(layer: Dict, x_scale: float, device) -> Dict:
    """``layer`` with its input site's scale ``x_scale`` (a 0-d f32 tensor on
    ``device``: divided by as a tensor, a graph can capture it) and ``xs_ws = x_scale ·
    w_scale`` in f32, the rescale of its product."""
    layer["x_scale"] = torch.tensor(x_scale, dtype=torch.float32, device=device)
    layer["xs_ws"] = (layer["x_scale"] * layer["w_scale"]).contiguous()
    return layer


def tree_to(q: Dict, device) -> Dict:
    """A copy of a forwards' tree with every tensor on ``device``."""
    if isinstance(q, dict):
        return {k: tree_to(v, device) for k, v in q.items()}
    return q.to(device) if isinstance(q, torch.Tensor) else q


def _is_patch_major(q: Dict, frames: torch.Tensor) -> bool:
    """True for the serving wire ``(N, H/p, W/p, p²·3)`` (uint8 or centered int8),
    False for NHWC."""
    p = q["patch"]
    return frames.dim() == 4 and frames.shape[-1] == p * p * 3


def _stem_patch_major(q: Dict, col_u8: torch.Tensor, *, out_scale: Optional[float] = None):
    """The patch-major stem: byte map (uint8 wire) or none (the centered wire's int8
    codes), K = p²·3 int8 GEMM, ×scale + bias, ReLU, and with ``out_scale`` the requant
    to int8 (bit-exact vs ``quantize_activations``)."""
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

    ``frames`` is the patch-major wire ``(N, H/p, W/p, p²·3)``, uint8 or centered int8
    (needs ``input_fold``), or on the CPU NHWC ``(N, H, W, 3)``: raw uint8 with
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


def tpucnn_resident_units(q: Dict, frames: torch.Tensor) -> Iterator[torch.Tensor]:
    """The outputs of ``quant_tpucnn_forward_resident``'s units in order, each computed
    when it is asked for: the stem, each stage's downsample and blocks, the pool. Each
    unit but the last block ends in int8 codes at its consumer's site, the last block in
    f32, the pool in the features. Run it under ``torch.inference_mode``."""
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
    yield x_q
    for si in range(stages):
        if si > 0:
            site = f"s{si}b0.in"
            x_q = _conv(x_q, q[f"down{si}"], stride=2, relu=True, out_scale=scales[site])
            yield x_q
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
            yield y
    yield y.mean(dim=(1, 2))


@torch.inference_mode()
def quant_tpucnn_forward_resident(q: Dict, frames: torch.Tensor) -> torch.Tensor:
    """int8-resident TPUVideoCNN features: every producer requantizes in its epilogue
    at the site of its consumers, so only int8 tensors lie between the convs.

    Same tree and the same conv inputs as ``quant_tpucnn_forward`` through the first
    block; the skip add reads ``x_q · scale[site]`` (``relu(o + deq)``) instead of
    the f32 activation. The last block's output stays f32 for the pooled mean.
    ``frames`` as in ``quant_tpucnn_forward``. The last of ``tpucnn_resident_units``."""
    for out in tpucnn_resident_units(q, frames):
        pass
    return out


# ---------------------------------------------------------------------------------
# ResNet-18 (``tpuhar/ops/quant.py:89-276``)
# ---------------------------------------------------------------------------------
RESNET_PAD = [(1, 1), (1, 1)]  # every 3×3 conv's padding: at stride 2 not SAME
STEM_K = 7 * 7 * 3  # the 7×7 stem's products, padded to a multiple of 64 for the kernel
STEM_K_PADDED = 192


def _resnet_blocks():
    """``(name, stride)`` of ResNet-18's eight basic blocks, in order."""
    return [(f"layer{li}_{bi}", 2 if (bi == 0 and li > 0) else 1) for li in range(4) for bi in range(2)]


def _folded_conv(conv_p, bn_p, bn_s, device):
    return fold_bn(
        _tensor(conv_p["kernel"], device), _tensor(bn_p["scale"], device), _tensor(bn_p["bias"], device),
        _tensor(bn_s["mean"], device), _tensor(bn_s["var"], device),
    )


@torch.inference_mode()
def calibrate_resnet18(params, batch_stats, frames: torch.Tensor) -> Dict[str, float]:
    """Per-site absmax over calibration ``frames`` (NHWC f32) through the f32 ResNet-18
    at eval, with BatchNorm folded. Sites are the conv inputs: ``stem``, and each
    block's ``.in`` (conv1's and the downsample's) and ``.mid`` (conv2's)."""
    device = frames.device
    stats: Dict[str, float] = {}

    def conv_bn(x, conv_p, bn_p, bn_s, stride, pad):
        kernel, bias = _folded_conv(conv_p, bn_p, bn_s, device)
        return conv_nhwc(x, kernel, stride, pad) + bias

    p, bs = params, batch_stats
    x = frames.float()
    _observed(stats, "stem", x)
    x = torch.relu(conv_bn(x, p["stem_conv"], p["stem_bn"], bs["stem_bn"], 2, [(3, 3), (3, 3)]))
    x = max_pool_nhwc(x, 3, 2, 1)
    for name, stride in _resnet_blocks():
        bp, bbs = p[name], bs[name]
        _observed(stats, f"{name}.in", x)
        h = torch.relu(conv_bn(x, bp["conv1"], bp["bn1"], bbs["bn1"], stride, RESNET_PAD))
        _observed(stats, f"{name}.mid", h)
        h = conv_bn(h, bp["conv2"], bp["bn2"], bbs["bn2"], 1, RESNET_PAD)
        res = x
        if "downsample_conv" in bp:
            res = conv_bn(x, bp["downsample_conv"], bp["downsample_bn"], bbs["downsample_bn"], stride, "VALID")
        x = torch.relu(h + res)
    return stats


@torch.inference_mode()
def quantize_resnet18(params, batch_stats, act_stats: Dict[str, float], *, device="cpu") -> Dict:
    """Fold BatchNorm and quantize every ResNet-18 conv per output channel; returns the
    forwards' tree (``resnet18_tree_from_numpy``) on ``device``."""

    def site_scale(name):
        return np.float32(max(act_stats.get(name, 1.0), 1e-6) / 127.0)

    def pack(conv_p, bn_p, bn_s):
        kernel, bias = _folded_conv(conv_p, bn_p, bn_s, device)
        w_q, w_s = quantize_weights(kernel, axis=-1)
        return {"w_q": w_q, "w_scale": w_s.reshape(-1), "bias": bias}

    q: Dict = {
        "act_scales": {k: site_scale(k) for k in act_stats},
        "stem": pack(params["stem_conv"], params["stem_bn"], batch_stats["stem_bn"]),
    }
    for name, _ in _resnet_blocks():
        bp, bbs = params[name], batch_stats[name]
        q[name] = {"conv1": pack(bp["conv1"], bp["bn1"], bbs["bn1"]), "conv2": pack(bp["conv2"], bp["bn2"], bbs["bn2"])}
        if "downsample_conv" in bp:
            q[name]["downsample"] = pack(bp["downsample_conv"], bp["downsample_bn"], bbs["downsample_bn"])
    return quantized_tree_from_numpy(q, device)


def resnet18_tree_from_numpy(q: Dict, device="cpu") -> Dict:
    """The JAX package's quantized ResNet-18 tree → the forwards' tree on ``device``.

    Each conv keeps ``w_q``/``w_scale``/``bias`` and gains its input site's ``x_scale``
    and ``xs_ws`` (``with_site``) and ``w_packed``, the K-major matrix its kernel reads:
    ``(64, 192)`` for the 7×7 stem (``(7·7·3, 64)`` transposed, its K of 147 padded with
    zero columns to 192, as the im2col rows are), ``(C_out, C)`` for a 1×1 downsample
    (``int8_gemm``) and ``(C_out, 9·C)`` for a 3×3 conv (``pack_conv3x3_i8``)."""
    scales = {k: float(np.float32(v)) for k, v in q["act_scales"].items()}
    stem = with_site(_leaves(q["stem"], device), scales["stem"], device)
    w = stem["w_q"].reshape(STEM_K, -1).T
    stem["w_packed"] = torch.nn.functional.pad(w, (0, STEM_K_PADDED - STEM_K)).contiguous()
    out: Dict = {"act_scales": scales, "stem": stem}
    for name, _ in _resnet_blocks():
        entry = q[name]
        block = {
            "conv1": with_site(_leaves(entry["conv1"], device), scales[f"{name}.in"], device),
            "conv2": with_site(_leaves(entry["conv2"], device), scales[f"{name}.mid"], device),
        }
        for conv in block.values():
            conv["w_packed"] = pack_conv3x3_i8(conv["w_q"])
        if "downsample" in entry:
            ds = with_site(_leaves(entry["downsample"], device), scales[f"{name}.in"], device)
            ds["w_packed"] = ds["w_q"].reshape(ds["w_q"].shape[-2], -1).T.contiguous()
            block["downsample"] = ds
        out[name] = block
    return out


def stem_im2col(x_q: torch.Tensor) -> torch.Tensor:
    """int8 ``(N, H, W, 3)`` → the 7×7 stride-2 stem's rows ``(N, Ho, Wo, 192)``: the
    input zero-padded by 3 (zero is the pad in int8 code space, as in JAX), then for each
    output pixel its 49 taps in the kernel's ``(dy, dx, c)`` order, and 45 zero columns."""
    N, H, W, C = x_q.shape
    xp = x_q.new_zeros((N, H + 6, W + 6, C))
    xp[:, 3:-3, 3:-3] = x_q
    patches = xp.unfold(1, 7, 2).unfold(2, 7, 2)  # (N, Ho, Wo, C, 7, 7)
    Ho, Wo = patches.shape[1:3]
    cols = x_q.new_zeros((N, Ho, Wo, STEM_K_PADDED))
    cols.view(N, Ho, Wo, STEM_K_PADDED // C, C)[:, :, :, : STEM_K // C].unflatten(3, (7, 7)).copy_(
        patches.permute(0, 1, 2, 4, 5, 3)
    )
    return cols


def _stem(q: Dict, frames: torch.Tensor, out_scale: Optional[float] = None) -> torch.Tensor:
    """``relu(int8_conv7x7(quantize(frames)) + bias)``: f32, or int8 at ``out_scale``."""
    stem = q["stem"]
    cols = stem_im2col(quantize_activations(frames, stem["x_scale"]))
    return int8_gemm(cols, stem["w_packed"], stem["xs_ws"], stem["bias"], relu=True, out_scale=out_scale)


def _downsample(x_q: torch.Tensor, ds: Dict, stride: int) -> torch.Tensor:
    """The 1×1 VALID conv at ``stride`` on int8 ``x_q``: the product on every
    ``stride``-th pixel, f32 out."""
    rows = x_q[:, ::stride, ::stride].contiguous()
    return int8_gemm(rows, ds["w_packed"], ds["xs_ws"], ds["bias"])


def _conv3(x_q, conv, stride=1, **kw):
    return conv3x3_i8(x_q, conv["w_packed"], conv["xs_ws"], conv["bias"], stride=stride, padding=RESNET_PAD, **kw)


def _max_pool_i8(x_q: torch.Tensor) -> torch.Tensor:
    """The stem's 3×3 stride-2 max-pool on int8 codes, through f16 (exact for them)."""
    return max_pool_nhwc(x_q.half(), 3, 2, 1).to(torch.int8).contiguous()


@torch.inference_mode()
def quant_resnet18_forward(q: Dict, frames: torch.Tensor) -> torch.Tensor:
    """int8 ResNet-18 features ``(N, 512)`` f32 from normalized NHWC f32 ``frames``,
    quantizing at each conv's input; the downsample reads the codes conv1 reads."""
    x = max_pool_nhwc(_stem(q, frames), 3, 2, 1).contiguous()
    for name, stride in _resnet_blocks():
        entry = q[name]
        x_q = quantize_activations(x, entry["conv1"]["x_scale"])
        h = _conv3(x_q, entry["conv1"], stride, relu=True)
        h = _conv3(quantize_activations(h, entry["conv2"]["x_scale"]), entry["conv2"], relu=False)
        res = _downsample(x_q, entry["downsample"], stride) if "downsample" in entry else x
        x = torch.relu(h + res)
    return x.mean(dim=(1, 2))


@torch.inference_mode()
def quant_resnet18_forward_resident(q: Dict, frames: torch.Tensor) -> torch.Tensor:
    """int8-resident ResNet-18 features ``(N, 512)`` f32: each producer requantizes in
    its epilogue at its consumers' site. The stem's requant goes before the max-pool
    (they commute); an identity skip is conv2's int8 residual ``x_q · scale[site]``; a
    downsample block's skip is the downsample's f32 output, so its conv2 stores f32 and
    ``relu(o + res)`` and the requant follow in PyTorch (bit for bit the same). Numerics
    as ``tpuhar/ops/quant.py: quant_resnet18_forward_resident``."""
    scales = q["act_scales"]
    blocks = _resnet_blocks()
    x_q = _max_pool_i8(_stem(q, frames, out_scale=scales["layer0_0.in"]))
    site = "layer0_0.in"
    for i, (name, stride) in enumerate(blocks):
        entry = q[name]
        nxt = None if i + 1 == len(blocks) else blocks[i + 1][0]
        h_q = _conv3(x_q, entry["conv1"], stride, relu=True, out_scale=scales[f"{name}.mid"])
        if "downsample" in entry:
            res = _downsample(x_q, entry["downsample"], stride)
            y = torch.relu(_conv3(h_q, entry["conv2"], relu=False) + res)
            if nxt is not None:
                x_q = quantize_activations(y, q[nxt]["conv1"]["x_scale"])
        else:
            y = _conv3(h_q, entry["conv2"], residual=x_q, res_scale=scales[site], relu=True,
                       out_scale=None if nxt is None else scales[f"{nxt}.in"])
            if nxt is not None:
                x_q = y
        site = f"{nxt}.in"
    return y.mean(dim=(1, 2))
