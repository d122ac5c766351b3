"""The entry points of the port: the serving forwards (twins of
``__graft_entry__._build_forward``), the pretraining task and the classification
stage's tasks.

Raw IMU counts ``(B, 250, 6)`` and a uint8 clip go through the fused window
featurizer, the IMU transformer, the video tower (ImageNet normalization folded into
its stem), two rounds of cross-attention fusion and the LayerNorm classifier head,
giving logits, MSP and energy OOD scores and the fused embedding. ``build_forward``
runs the tower in the compute dtype: the flagship's ``tpu_cnn`` (``flagship_config``,
the clip shipped patch-major) or the ``videomae_base`` ViT (``vit_config``, the clip
NHWC, attention through the flash kernel); ``build_int8_forward`` runs a tower's int8
PTQ form (``serving_quant``: ``tpu_cnn``, ResNet-18 or a ViT), for ``tpu_cnn`` the
program the JAX package's ``bench.py`` reports as its headline. ``build_pretrain_task`` builds the cross-modal SigLIP
pretraining of ``pretrain_config`` (``tpuhar/cli.py: Pipeline.run_pretraining``);
``build_classification_task`` the IMU classifier's linear probe or finetune of
``classify_config`` (``Pipeline.run_classification``), ``build_video_task`` and
``build_fusion_task`` the video-only and fusion classifiers.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .bridge import init_params, load_variables
from .config import Config
from .models.crossmodal import CrossModalModel, FusionClassifier, IMUClassifier, VideoClassifier
from .ood import energy_score, msp_score
from .ops.fold import fold_normalization
from .ops.fused_window import featurize_windows_auto
from .ops.stem import to_patch_major
from .ops.video import clip_stats, normalize_clip
from .train import factory


def flagship_config(compute_dtype: str = "bfloat16"):
    """The flagship serving configuration (``__graft_entry__._flagship_config``) in
    the form the port runs: the ``tpu_cnn`` tower with its residual convs fused
    (``conv_backend="pallas"`` in the JAX package)."""
    cfg = Config()
    m = cfg.model
    m.video_backbone = "tpu_cnn"
    m.video_pretrained = False
    m.compute_dtype = compute_dtype
    m.head_norm = "layer"
    m.conv_backend = "pallas"
    return cfg


def vit_config(compute_dtype: str = "bfloat16"):
    """The ``videomae_base`` fusion model as the JAX package serves it
    (``InferenceEngine(fast_gelu=True, fast_attention=True)``): the tanh GELU and the
    flash attention, with the flagship's IMU encoder, fusion and head. One Hopper
    kernel serves both of the JAX package's flash kernels at every block size, so the
    port reads neither ``flash_kernel`` nor ``flash_block_q``/``flash_block_k``."""
    cfg = Config()
    m = cfg.model
    m.video_backbone = "videomae_base"
    m.video_pretrained = False
    m.compute_dtype = compute_dtype
    m.head_norm = "layer"
    m.gelu_approximate = True
    m.use_flash_attention = True
    return cfg


def pretrain_config():
    """The pretraining stage's configuration: ``Config()`` (``videomae_base``, bf16
    compute with f32 parameters, BatchNorm projection heads, the exact-erf GELU that
    training keeps, IMU dropout 0.1, SigLIP with trainable scalars, batch 16, AdamW at
    1e-4 with weight decay 0.01, clipping at 1.0) with the flash attention of the stock
    Pallas kernel (``flash_kernel="library"``, the one whose backward the TPU runs) and
    weights drawn from a seed (``video_pretrained=False``)."""
    cfg = Config()
    m = cfg.model
    m.use_flash_attention = True
    m.flash_kernel = "library"
    m.video_pretrained = False
    return cfg


def _params(cfg, params: Optional[Dict], seed: int, model_cls) -> Dict:
    """``params``, or a tree of ``model_cls`` drawn from ``torch.Generator().manual_seed(seed)``."""
    return init_params(cfg, torch.Generator().manual_seed(seed), model_cls) if params is None else params


def build_pretrain_task(cfg, *, device, seed: int = 0, params: Optional[Dict] = None, steps_per_epoch: int,
                        mesh=None):
    """The pretraining task of ``cfg`` on ``device`` (``train/factory.Task``: the model
    with f32 master weights, its ``TrainState`` and ``train_step``/``eval_step``).

    ``params`` is a flax-layout variable tree of ``CrossModalModel`` (``None`` draws one
    with ``init_params`` from ``torch.Generator().manual_seed(seed)``);
    ``steps_per_epoch`` sets the schedule. Batches are ``{"imu": (B, C, T) featurized f32,
    "video": (B, T, H, W, 3) uint8}`` on ``device``. ``mesh`` (``parallel.mesh``) makes
    the steps data parallel over it."""
    return factory.build_crossmodal_task(cfg, steps_per_epoch, _params(cfg, params, seed, CrossModalModel),
                                         device=device, mesh=mesh)


def classify_config():
    """The classification stage's configuration: the flagship's IMU classifier
    (``flagship_config``: the transformer encoder at d=128 with 4 layers and 8 heads on
    91 tokens, the LayerNorm head 256 → 128 → 32 classes with dropout 0.3, bf16 compute
    with f32 masters) trained at ``train_batch_size`` 64: AdamW with weight decay 0.01,
    the head at 1e-3 and the encoder at 1e-6 (finetune), each decaying to 1e-7 over
    ``train_epochs``, clipping at 1.0."""
    cfg = flagship_config()
    cfg.training.train_batch_size = 64
    return cfg


def build_classification_task(
    cfg,
    mode: str,
    *,
    device,
    seed: int = 0,
    params: Optional[Dict] = None,
    steps_per_epoch: int,
    encoder_params: Optional[Dict] = None,
    encoder_batch_stats: Optional[Dict] = None,
    mesh=None,
):
    """The IMU classifier's task in ``mode`` ("linear_probe" or "finetune") on ``device``.

    ``params`` is an ``IMUClassifier`` tree (``None`` draws one from ``seed``);
    ``encoder_params`` (and ``encoder_batch_stats``) replace its ``imu_encoder``, such as
    the subtree of a pretraining state's ``bridge.variables_to_numpy``. Batches are
    ``{"imu": (B, C, T) featurized f32, "label": (B,) int}`` on ``device`` (plus
    ``"n_valid"`` for ``predict_step``)."""
    return factory.build_classification_task(
        cfg, mode, steps_per_epoch, _params(cfg, params, seed, IMUClassifier),
        encoder_params=encoder_params, encoder_batch_stats=encoder_batch_stats, device=device, mesh=mesh,
    )


def build_video_task(cfg, *, device, seed: int = 0, params: Optional[Dict] = None, steps_per_epoch: int,
                     mesh=None):
    """The video-only classifier's task on ``device`` (``params`` a ``VideoClassifier``
    tree, ``None`` draws one from ``seed``). Batches are ``{"video": (B, T, H, W, 3)
    uint8, "label"}``."""
    return factory.build_video_task(cfg, steps_per_epoch, _params(cfg, params, seed, VideoClassifier), device=device,
                                    mesh=mesh)


def build_fusion_task(
    cfg,
    *,
    device,
    seed: int = 0,
    params: Optional[Dict] = None,
    steps_per_epoch: int,
    encoder_params: Optional[Dict] = None,
    mesh=None,
):
    """The fusion classifier's task on ``device`` (``params`` a ``FusionClassifier``
    tree, ``None`` draws one from ``seed``; ``encoder_params`` replaces its
    ``imu_encoder``). Batches are ``{"imu", "video" (B, T, H, W, 3) uint8, "label"}``."""
    return factory.build_fusion_task(
        cfg, steps_per_epoch, _params(cfg, params, seed, FusionClassifier),
        encoder_params=encoder_params, device=device, mesh=mesh,
    )


def featurize(cfg, imu_raw: torch.Tensor) -> torch.Tensor:
    """The serving featurization of ``cfg.data``: raw counts ``(B, T, 6)`` → ``(B, 6,
    T)`` f32 (``ops/fused_window.featurize_windows_auto``)."""
    d = cfg.data
    return featurize_windows_auto(
        imu_raw, kernel_size=d.median_filter_kernel, normalize=d.normalize_imu, racc=d.Racc, rgyro=d.Rgyro,
    )


def fusion_program(cfg, params: Dict, *, device, fold_normalize: bool = True):
    """The fusion model of ``cfg`` on ``device`` in ``cfg.model.compute_dtype``, as
    ``(fn(imu_raw, video_u8) -> (logits, embeddings), folded)``: ``params`` is a
    flax-layout tree before any folding; ``folded`` says whether the ImageNet
    normalization went into the stem (the clip is then consumed raw), else the clip is
    normalized on the device with statistics made here, once. ``cfg`` is used as it is
    (``build_forward`` and ``serving.InferenceEngine`` make their overrides first)."""
    dtype = getattr(torch, cfg.model.compute_dtype)
    folded = False
    if fold_normalize:
        params, folded = fold_normalization(params, cfg)
    model = load_variables(FusionClassifier(cfg, dtype=dtype), params).to(device).eval()
    mean, std = clip_stats(device)

    @torch.inference_mode()
    def run(imu_raw: torch.Tensor, video_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        video = video_u8.to(dtype) if folded else normalize_clip(video_u8, mean=mean, std=std)
        return model(featurize(cfg, imu_raw), video)

    return run, folded


def build_forward(
    cfg,
    batch: int,
    *,
    device,
    seed: int = 0,
    params: Optional[Dict] = None,
    fold_normalize: bool = True,
) -> Tuple[Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]], Tuple]:
    """Returns ``(fn(imu_raw, video_u8) -> dict, example_args)``; fn closes over the
    model on ``device`` in ``cfg.model.compute_dtype``.

    ``params`` is a flax-layout variable tree (``bridge``) before any folding, such
    as JAX's ``forward._variables_prefold``; ``None`` draws one with
    ``init_params`` from ``torch.Generator().manual_seed(seed)``. With
    ``fold_normalize`` the clip is consumed raw: patch-major ``(B, T, H/16, W/16,
    768)`` for a ``tpu_cnn`` tower, NHWC ``(B, T, H, W, 3)`` for a ViT; unfolded, it
    is NHWC and normalized on the device. A ViT backbone (any name with ``/`` or
    ``videomae``) serves with the tanh GELU, as ``__graft_entry__._build_forward`` and
    ``InferenceEngine`` serve it: the override is made on a copy of ``cfg``.
    """
    bb = cfg.model.video_backbone
    if "/" in bb or "videomae" in bb.lower():
        cfg = copy.deepcopy(cfg)
        cfg.model.gelu_approximate = True
    d = cfg.data
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed))
    run, folded = fusion_program(cfg, params, device=device, fold_normalize=fold_normalize)

    H, W = d.video_resize
    video_example = np.zeros((batch, d.video_frames_per_window, H, W, 3), np.uint8)
    if folded and cfg.model.video_backbone.startswith("tpu_cnn"):
        video_example = to_patch_major(video_example)
    example_args = (
        torch.zeros((batch, d.imu_window_size, d.imu_channels), device=device),
        torch.from_numpy(video_example).to(device),
    )

    @torch.inference_mode()
    def forward(imu_raw: torch.Tensor, video_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw sensor counts + uint8 pixels → logits, OOD scores and embeddings."""
        logits, fused = run(imu_raw, video_u8)
        return {
            "logits": logits,
            "msp": msp_score(logits),
            "energy": energy_score(logits),
            "embeddings": fused,
        }

    return forward, example_args


def build_int8_forward(
    cfg,
    batch: int,
    *,
    device,
    seed: int = 0,
    params: Optional[Dict] = None,
    calib_clips: Optional[np.ndarray] = None,
    resident: Optional[bool] = None,
) -> Tuple[Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]], Tuple]:
    """The int8 PTQ serving forward of a configuration whose tower the JAX package
    quantizes (``tpu_cnn``, ResNet-18, the ViTs), as its ``bench.py`` builds its
    headline program: returns ``(fn(imu_raw, video_u8) -> dict, example_args)`` from
    ``serving_quant.build_quantized_forward``.

    ``params`` is a flax-layout variable tree before any folding (``None`` draws one
    with ``init_params`` from ``seed``); ``calib_clips`` defaults to 2 clips of
    uint8 noise from ``np.random.default_rng(seed)``. The clip is consumed raw:
    patch-major ``(B, T, H/16, W/16, 768)`` for a ``tpu_cnn`` tower (the example is the
    uint8 wire; the returned ``fn`` takes the centered int8 wire as well, as the JAX
    package's program does), NHWC ``(B, T, H, W, 3)`` otherwise. ``resident`` picks a CNN tower's int8-resident form (``None``: the
    resident form of a CNN tower, the baseline of a ViT, which has no other; ``True``
    with a ViT raises).
    """
    from .serving_quant import _VIT_BACKBONES, build_quantized_forward

    d = cfg.data
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed))
    H, W = d.video_resize
    if calib_clips is None:
        calib_clips = (
            np.random.default_rng(seed).random((2, d.video_frames_per_window, H, W, 3)) * 255
        ).astype(np.uint8)
    if resident is None:
        resident = cfg.model.video_backbone not in _VIT_BACKBONES
    fn = build_quantized_forward(cfg, params, calib_clips, device=device, resident=resident)
    video_example = np.zeros((batch, d.video_frames_per_window, H, W, 3), np.uint8)
    if cfg.model.video_backbone.startswith("tpu_cnn"):
        video_example = to_patch_major(video_example)
    example_args = (
        torch.zeros((batch, d.imu_window_size, d.imu_channels), device=device),
        torch.from_numpy(video_example).to(device),
    )
    return fn, example_args
