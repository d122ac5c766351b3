"""Quantized serving path: the int8 ``tpu_cnn`` tower + the fusion stack
(``tpuhar/serving_quant.py``).

``build_quantized_forward`` calibrates per-site activation scales on a few clips (on
the CPU, as the JAX package does),
quantizes the tower with the ImageNet normalization folded into its stem (the stem
consumes raw uint8), and returns ``fn(imu_raw, video_u8) -> {logits, msp, energy,
embeddings}``. The clip arrives as the uint8 patch-major wire ``(B, T, H/p, W/p,
p²·3)``; on a CUDA device the stem runs through the stem kernel and every 3×3 conv
through the int8 conv kernel.

**Logit recalibration** (on by default): quantization drifts the logit distribution,
which shifts the MSP/energy OOD scores even where predictions hold. At build time the
calibration clips are scored through both the model's own program (in its compute
dtype) and the int8 program, and a closed-form per-class affine map is fitted so that
the int8 program emits the other's logit distribution.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .bridge import load_variables
from .models.crossmodal import FusionClassifier
from .ood import energy_score, full_f32, msp_score
from .ops.fused_window import featurize_windows_auto
from .ops.quant import (
    calibrate_tpucnn,
    quant_tpucnn_forward,
    quant_tpucnn_forward_resident,
    quantize_tpucnn,
    tree_to,
)
from .ops.stem import to_patch_major
from .ops.video import IMAGENET_MEAN, IMAGENET_STD, normalize_clip

_TPU_CNN_BACKBONES = ("tpu_cnn", "tpu_cnn_large")


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


def _check_backbone(cfg) -> None:
    backbone = cfg.model.video_backbone
    if backbone in _TPU_CNN_BACKBONES:
        return
    if backbone not in _QUANT_BACKBONES:
        raise ValueError(f"quantized path supports backbones {sorted(_QUANT_BACKBONES)}, got {backbone!r}")
    raise NotImplementedError(
        f"the quantized path of the port supports {_TPU_CNN_BACKBONES}, not {backbone!r}: the int8 towers "
        "(the ViT and ResNet-18) are ROADMAP queue 1 item 4"
    )


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
    """``fn(imu_raw, video_u8)`` over a quantized tree ``q`` (on ``device``) and a
    ``FusionClassifier`` holding the same variables; ``projection`` is the video
    encoder's ``{"kernel", "bias"}``, applied in f32 to the tower's features.
    ``fn.recalibration`` is the affine logit map ``(a, b)`` or None; ``fn.core`` is the
    same program without the OOD scores, ``(imu_raw, video_u8) -> (logits, embeddings)``."""
    d = cfg.data
    tower = quant_tpucnn_forward_resident if resident else quant_tpucnn_forward
    proj_kernel = torch.tensor(np.asarray(projection["kernel"], np.float32), device=device)
    proj_bias = torch.tensor(np.asarray(projection["bias"], np.float32), device=device)
    recal = None
    if recalibration is not None:
        recal = tuple(torch.tensor(np.asarray(v, np.float32), device=device) for v in recalibration)
    model_dtype = model.video_to_fusion.weight.dtype

    @torch.inference_mode()
    def core(imu_raw: torch.Tensor, video_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw sensor counts + the uint8 patch-major clip → (logits, embeddings)."""
        B, T = video_u8.shape[:2]
        imu = featurize_windows_auto(
            imu_raw, kernel_size=d.median_filter_kernel, normalize=d.normalize_imu,
            racc=d.Racc, rgyro=d.Rgyro,
        )
        feats = tower(q, video_u8.reshape(B * T, *video_u8.shape[2:])).reshape(B, T, -1)
        tokens = feats @ proj_kernel + proj_bias  # f32, as the JAX package computes it
        logits, fused = model.fuse_with_tokens(imu, tokens.to(model_dtype))
        if recal is not None:
            logits = recal[0] * logits + recal[1]
        return logits, fused

    @torch.inference_mode()
    def forward(imu_raw: torch.Tensor, video_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw sensor counts + the uint8 patch-major clip → logits, OOD scores and
        embeddings."""
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
    """The quantized ``tpu_cnn`` tower of ``variables`` (flax layout, before folding) on
    ``device``, with the ImageNet normalization folded into the stem. It is calibrated
    on the first 64 frames of ``calib_clips_u8`` and quantized on the CPU, as the JAX
    package does (``tpuhar/serving_quant.py``): a calibration on the card sums in another
    order, moves observed maxima and with them site scales and codes (7 of the 11
    ``x_scale``/``w_q`` leaves of the flagship's tree differed on an H100)."""
    backbone = variables["params"]["video_encoder"]["backbone"]
    stats = variables["batch_stats"]["video_encoder"]["backbone"]
    clips = np.asarray(calib_clips_u8)
    with full_f32():
        norm = normalize_clip(torch.from_numpy(clips))
        act_stats = calibrate_tpucnn(backbone, stats, norm.reshape(-1, *clips.shape[2:4], 3)[:64])
        q = quantize_tpucnn(
            backbone, stats, act_stats, input_fold=(IMAGENET_MEAN, IMAGENET_STD), device="cpu"
        )
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

    ``variables`` is a flax-layout ``FusionClassifier`` tree (``bridge``) with a
    ``tpu_cnn`` or ``tpu_cnn_large`` tower, before any folding; ``calib_clips_u8`` is
    ``(Ncal, T, H, W, 3)`` uint8, used for the activation calibration (its first 64
    frames) and, when ``recalibrate``, for fitting the affine logit map against the
    model's own program. ``calib_imu_raw`` optionally pairs ``(Ncal, window,
    channels)`` raw IMU counts with the clips for that fit; without it seeded
    surrogate counts are used. ``fn.recalibration`` is ``(a, b)`` or None;
    ``fn.quantized_tree`` the quantized tower; ``fn.core`` the program without the OOD
    scores.

    ``resident=True`` serves through ``quant_tpucnn_forward_resident`` (int8 between
    the convs), else ``quant_tpucnn_forward``. The activation calibration runs on the CPU
    (``build_quantized_tree``), the logit recalibration on ``device`` with TF32 off. The returned ``fn`` takes the clip as the uint8
    patch-major wire ``(B, T, H/p, W/p, p²·3)`` (``ops/stem.to_patch_major``).
    """
    _check_backbone(cfg)
    d = cfg.data
    dtype = getattr(torch, cfg.model.compute_dtype)
    model = load_variables(FusionClassifier(cfg, dtype=dtype), variables).to(device).eval()
    venc = variables["params"]["video_encoder"]

    clips = np.asarray(calib_clips_u8)
    q = build_quantized_tree(variables, clips, device=device)

    recal = None
    if recalibrate:
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
            col = torch.from_numpy(to_patch_major(clips, q["patch"])).to(device)
            l8 = raw(imu_t, col)["logits"].float().cpu().numpy()
        recal = fit_logit_recalibration(lf, l8)
    return quantized_forward(
        cfg, model, q, venc["projection"], device=device, recalibration=recal, resident=resident
    )
