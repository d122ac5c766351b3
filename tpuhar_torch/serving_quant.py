"""Quantized serving path: an int8 video tower + the fusion stack
(``tpuhar/serving_quant.py``).

``build_quantized_forward`` calibrates per-site activation scales on a few clips (on
the CPU, as the JAX package does), quantizes the tower and returns ``fn(imu_raw,
video_u8) -> {logits, msp, energy, embeddings}``. The towers and the clip each takes:

- ``tpu_cnn``/``tpu_cnn_large`` (baseline or int8-resident): the ImageNet normalization
  folded into the stem, the clip as the uint8 patch-major wire ``(B, T, H/p, W/p,
  p²·3)`` or its centered int8 codes (``ops/stem.to_patch_major(..., centered=True)``);
  on a CUDA device the stem runs through the stem kernel (the centered codes through
  its signed form, the int8 GEMM kernel) and every 3×3 conv through the int8 conv
  kernel;
- ``resnet18`` (baseline or int8-resident): no fold, the raw NHWC uint8 clip normalized
  on the device and quantized at the stem; on a CUDA device the 7×7 stem and the 1×1
  downsample convs run through the int8 GEMM kernel, the 3×3 convs through the int8
  conv kernel;
- ``videomae_tiny``/``small``/``base`` (baseline only): the normalization folded into
  the tubelet stem, the raw NHWC uint8 clip in, tokens out; on a CUDA device the stem
  runs through the stem kernel and every dense layer through the int8 GEMM kernel.

**Logit recalibration** (on by default): quantization drifts the logit distribution,
which shifts the MSP/energy OOD scores even where predictions hold. At build time the
calibration clips are scored through both the model's own program (in its compute
dtype) and the int8 program, and a closed-form per-class affine map is fitted so that
the int8 program emits the other's logit distribution.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .bridge import load_variables
from .models.crossmodal import FusionClassifier
from .ood import energy_score, full_f32, msp_score
from .ops.fused_window import featurize_windows_auto
from .ops.quant import (
    calibrate_resnet18,
    calibrate_tpucnn,
    quant_resnet18_forward,
    quant_resnet18_forward_resident,
    quant_tpucnn_forward,
    quant_tpucnn_forward_resident,
    quantize_resnet18,
    quantize_tpucnn,
    tree_to,
)
from .ops.quant_vit import calibrate_vit, quant_vit_forward, quantize_vit
from .ops.stem import to_patch_major
from .ops.video import IMAGENET_MEAN, IMAGENET_STD, clip_stats, normalize_clip


def fit_logit_recalibration(
    f32_logits, int8_logits, *, shrink_samples: int = 32
) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form affine map ``l → a·l + b`` aligning int8 logits to f32 logits.

    Least squares over calibration samples, per class column (``a``, ``b`` are
    ``(num_classes,)``), with each per-class scale shrunk toward the shared scalar
    solution by ``N/(N+shrink_samples)`` so tiny calibration sets degrade to the
    robust scalar fit instead of overfitting.
    """
    lf = np.asarray(f32_logits, np.float64)
    l8 = np.asarray(int8_logits, np.float64)
    if lf.shape != l8.shape or lf.ndim != 2:
        raise ValueError(f"paired 2-D logits required, got {lf.shape} vs {l8.shape}")
    n = lf.shape[0]
    l8c = l8 - l8.mean(0)
    lfc = lf - lf.mean(0)
    denom_s = float((l8c * l8c).sum())
    a_scalar = float((l8c * lfc).sum() / denom_s) if denom_s > 1e-12 else 1.0
    if not np.isfinite(a_scalar) or a_scalar <= 0:
        a_scalar = 1.0
    denom_c = (l8c * l8c).sum(0)
    with np.errstate(divide="ignore", invalid="ignore"):
        a_cls = (l8c * lfc).sum(0) / denom_c
    a_cls = np.where(np.isfinite(a_cls) & (a_cls > 0), a_cls, a_scalar)
    w = n / (n + float(shrink_samples))
    a = w * a_cls + (1.0 - w) * a_scalar
    b = lf.mean(0) - a * l8.mean(0)
    return a.astype(np.float32), b.astype(np.float32)


# the towers the JAX package quantizes (its serving_quant._QUANT_BACKBONES)
_QUANT_BACKBONES = ("resnet18", "tpu_cnn", "tpu_cnn_large", "videomae_base", "videomae_small", "videomae_tiny")
_VIT_BACKBONES = ("videomae_base", "videomae_small", "videomae_tiny")


def _check_backbone(cfg, resident: bool) -> None:
    backbone = cfg.model.video_backbone
    if backbone not in _QUANT_BACKBONES:
        raise ValueError(f"quantized path supports backbones {sorted(_QUANT_BACKBONES)}, got {backbone!r}")
    if resident and backbone in _VIT_BACKBONES:
        raise ValueError(
            "the int8-resident path is CNN-only (producer-side quantization through conv "
            "trunks); ViT towers use the baseline int8 path"
        )


def _tower_kind(tree: Dict) -> str:
    """``"vit"``, ``"resnet18"`` or ``"tpu_cnn"``: the tower a quantized tree is of."""
    if "depth" in tree:
        return "vit"
    return "resnet18" if "layer0_0" in tree else "tpu_cnn"


def quantized_forward(
    cfg,
    model: FusionClassifier,
    q: Dict,
    projection: Dict,
    *,
    device,
    recalibration: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    resident: bool = False,
):
    """``fn(imu_raw, video_u8)`` over a quantized tree ``q`` (on ``device``; its tower
    is told by its keys) and a ``FusionClassifier`` holding the same variables;
    ``projection`` is the video encoder's ``{"kernel", "bias"}``, applied in f32 to the
    tower's features or tokens. ``fn.recalibration`` is the affine logit map ``(a, b)``
    or None; ``fn.core`` is the same program without the OOD scores, ``(imu_raw,
    video_u8) -> (logits, embeddings)``. ``video_u8`` is the clip the tower takes (module
    docstring): patch-major for ``tpu_cnn`` (uint8 or centered int8), NHWC otherwise."""
    _check_backbone(cfg, resident)
    d = cfg.data
    kind = _tower_kind(q)
    if kind == "resnet18":
        tower = quant_resnet18_forward_resident if resident else quant_resnet18_forward
    else:
        tower = quant_tpucnn_forward_resident if resident else quant_tpucnn_forward
    proj_kernel = torch.tensor(np.asarray(projection["kernel"], np.float32), device=device)
    proj_bias = torch.tensor(np.asarray(projection["bias"], np.float32), device=device)
    recal = None
    if recalibration is not None:
        recal = tuple(torch.tensor(np.asarray(v, np.float32), device=device) for v in recalibration)
    model_dtype = model.video_to_fusion.weight.dtype
    mean, std = clip_stats(device)  # ResNet-18's normalization, made once: a graph can capture it

    def features(video_u8: torch.Tensor) -> torch.Tensor:
        if kind == "vit":  # whole clips, raw uint8 in: tokens (B, N, d)
            return quant_vit_forward(q, video_u8)
        B, T = video_u8.shape[:2]
        frames = video_u8 if kind == "tpu_cnn" else normalize_clip(video_u8, mean=mean, std=std)
        return tower(q, frames.reshape(B * T, *frames.shape[2:])).reshape(B, T, -1)

    @torch.inference_mode()
    def core(imu_raw: torch.Tensor, video_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw sensor counts + the uint8 clip → (logits, embeddings)."""
        imu = featurize_windows_auto(
            imu_raw, kernel_size=d.median_filter_kernel, normalize=d.normalize_imu,
            racc=d.Racc, rgyro=d.Rgyro,
        )
        tokens = features(video_u8) @ proj_kernel + proj_bias  # f32, as the JAX package computes it
        logits, fused = model.fuse_with_tokens(imu, tokens.to(model_dtype))
        if recal is not None:
            logits = recal[0] * logits + recal[1]
        return logits, fused

    @torch.inference_mode()
    def forward(imu_raw: torch.Tensor, video_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw sensor counts + the uint8 clip → logits, OOD scores and embeddings."""
        logits, fused = core(imu_raw, video_u8)
        return {
            "logits": logits,
            "msp": msp_score(logits),
            "energy": energy_score(logits, cfg.ood.energy_temperature),
            "embeddings": fused,
        }

    forward.recalibration = recalibration
    forward.quantized_tree = q
    forward.core = core
    return forward


def build_quantized_tree(variables: Dict, calib_clips_u8: np.ndarray, *, device) -> Dict:
    """The quantized video tower of ``variables`` (flax layout, before folding) on
    ``device``, calibrated and quantized on the CPU, as the JAX package does
    (``tpuhar/serving_quant.py:141-176``): a calibration on the card sums in another
    order, moves observed maxima and with them site scales and codes (7 of the 11
    ``x_scale``/``w_q`` leaves of the flagship's tree differed on an H100).

    The tower is told by the tree: a ViT (``video_encoder.vit``) is calibrated on the
    first ``max(64 // T, 2)`` whole clips and its stem takes the ImageNet fold; ResNet-18
    (``layer0_0``) on the first 64 frames, unfolded; ``tpu_cnn`` on the first 64 frames,
    its stem folded."""
    venc = variables["params"]["video_encoder"]
    clips = np.asarray(calib_clips_u8)
    fold = (IMAGENET_MEAN, IMAGENET_STD)
    with full_f32():
        norm = normalize_clip(torch.from_numpy(clips))
        if "vit" in venc:
            vit = venc["vit"]
            act_stats = calibrate_vit(vit, {}, norm[: max(64 // norm.shape[1], 2)])
            q = quantize_vit(vit, {}, act_stats, input_fold=fold, device="cpu")
        else:
            backbone = venc["backbone"]
            stats = variables["batch_stats"]["video_encoder"]["backbone"]
            frames = norm.reshape(-1, *clips.shape[2:4], 3)[:64]
            if "layer0_0" in backbone:
                q = quantize_resnet18(backbone, stats, calibrate_resnet18(backbone, stats, frames), device="cpu")
            else:
                act_stats = calibrate_tpucnn(backbone, stats, frames)
                q = quantize_tpucnn(backbone, stats, act_stats, input_fold=fold, device="cpu")
    return tree_to(q, device)


def build_quantized_forward(
    cfg,
    variables: Dict,
    calib_clips_u8: np.ndarray,
    *,
    device,
    calib_imu_raw: Optional[np.ndarray] = None,
    recalibrate: bool = True,
    resident: bool = False,
):
    """Returns ``fn(imu_raw, video_u8) -> {logits, msp, energy, embeddings}``.

    ``variables`` is a flax-layout ``FusionClassifier`` tree (``bridge``) with a tower of
    ``_QUANT_BACKBONES``, before any folding; ``calib_clips_u8`` is ``(Ncal, T, H, W, 3)``
    uint8, used for the activation calibration (``build_quantized_tree``) and, when
    ``recalibrate``, for fitting the affine logit map against the model's own program.
    ``calib_imu_raw`` optionally pairs ``(Ncal, window, channels)`` raw IMU counts with
    the clips for that fit; without it seeded surrogate counts are used. ``fn.recalibration`` is ``(a, b)`` or None;
    ``fn.quantized_tree`` the quantized tower; ``fn.core`` the program without the OOD
    scores.

    ``resident=True`` serves a CNN tower's int8-resident forward (int8 between the
    convs), else its baseline forward; a ViT has no resident form (``ValueError``, as in
    the JAX package). The activation calibration runs on the CPU
    (``build_quantized_tree``), the logit recalibration on ``device`` with TF32 off.
    ``fn.build_seconds`` holds the two's times. The returned ``fn`` takes the clip as
    the tower takes it (module docstring): the patch-major wire ``(B, T, H/p, W/p,
    p²·3)`` (``ops/stem.to_patch_major``) for ``tpu_cnn``, uint8 or centered int8 (the
    stem branches on the dtype), NHWC ``(B, T, H, W, 3)`` uint8 otherwise.
    """
    _check_backbone(cfg, resident)
    d = cfg.data
    dtype = getattr(torch, cfg.model.compute_dtype)
    model = load_variables(FusionClassifier(cfg, dtype=dtype), variables).to(device).eval()
    venc = variables["params"]["video_encoder"]

    clips = np.asarray(calib_clips_u8)
    t0 = time.perf_counter()
    q = build_quantized_tree(variables, clips, device=device)
    seconds = {"calibration": time.perf_counter() - t0, "recalibration": 0.0}

    recal = None
    if recalibrate:
        t1 = time.perf_counter()
        if calib_imu_raw is not None:
            imu_cal = np.asarray(calib_imu_raw, np.float32)
        else:
            imu_cal = (
                np.random.default_rng(0)
                .normal(0.0, 8000.0, (len(clips), d.imu_window_size, d.imu_channels))
                .astype(np.float32)
            )
        imu_t = torch.from_numpy(imu_cal).to(device)
        norm = normalize_clip(torch.from_numpy(clips).to(device))
        raw = quantized_forward(cfg, model, q, venc["projection"], device=device, resident=resident)
        with full_f32(), torch.inference_mode():
            imu = featurize_windows_auto(
                imu_t, kernel_size=d.median_filter_kernel, normalize=d.normalize_imu,
                racc=d.Racc, rgyro=d.Rgyro,
            )
            lf = model(imu, norm)[0].float().cpu().numpy()
            wire = to_patch_major(clips, q["patch"]) if _tower_kind(q) == "tpu_cnn" else clips
            l8 = raw(imu_t, torch.from_numpy(wire).to(device))["logits"].float().cpu().numpy()
        recal = fit_logit_recalibration(lf, l8)
        seconds["recalibration"] = time.perf_counter() - t1
    fn = quantized_forward(
        cfg, model, q, venc["projection"], device=device, recalibration=recal, resident=resident
    )
    fn.build_seconds = seconds
    return fn
