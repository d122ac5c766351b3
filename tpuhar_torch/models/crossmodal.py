"""Composite models (``tpuhar/models/crossmodal.py``): the cross-modal contrastive
model that pretraining trains; the IMU, video-only and cross-attention IMU+video fusion
classifiers that the classification stage trains and the serving forwards run.

Each builds its modules in the compute ``dtype`` and records each parameter's dtype as
built (``use_dtypes``), so that a training copy can keep f32 master weights and run
``forward_cast``, which casts each to that dtype at use, as flax casts its f32
parameters to ``dtype``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .imu import build_imu_encoder
from .layers import ClassifierHead, CrossAttentionBlock, ProjectionHead, l2_normalize
from .video import build_video_encoder


class _Method(nn.Module):
    """A call of ``model``'s attribute ``name`` (a method or a submodule) as a module's
    ``forward``, which is the one entry ``torch.func.functional_call`` reaches."""

    def __init__(self, model: nn.Module, name: str):
        super().__init__()
        self.model, self.method = model, name

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


class MasterWeights(nn.Module):
    """``forward_cast`` over the dtypes recorded by ``record_use_dtypes``."""

    def record_use_dtypes(self) -> None:
        self.use_dtypes = {name: p.dtype for name, p in self.named_parameters()}

    def forward_cast(self, *args, method: str = "forward", **kwargs):
        """``forward``, or the method or submodule that ``method`` names
        (``"fuse_with_tokens"``, ``"video_encoder"``), with every parameter cast to its
        ``use_dtypes`` entry at use: on a model whose parameters were made f32 masters
        (``.float()``), the modules compute in the dtype they were built in and the
        gradients reach the f32 leaves."""
        params = {f"model.{name}": p.to(self.use_dtypes[name]) for name, p in self.named_parameters()}
        return torch.func.functional_call(_Method(self, method), params, args, kwargs)


class CrossModalModel(MasterWeights):
    """IMU and video encoders, a projection head each, unit-norm embeddings and the live
    SigLIP scalars ``temperature`` (log-temperature, log 10 at init) and ``bias`` (−10).

    ``forward(imu (B, C, T), video (B, T, H, W, 3) normalized float, *, train, generator)``
    → ``{"imu_proj", "video_proj"}`` ``(B, projection_dim)`` f32 unit-norm,
    ``"logit_scale"``/``"logit_bias"`` (detached with ``train_loss_scalars=False``, as
    flax's ``stop_gradient``) and ``"imu_tokens"``/``"video_tokens"``.
    """

    init_values = {"temperature": math.log(10.0), "bias": -10.0}  # read by bridge.init_params

    def __init__(self, config, *, train_loss_scalars: bool = True, dtype=None):
        super().__init__()
        m = config.model
        dtype = dtype or getattr(torch, m.compute_dtype)
        self.train_loss_scalars = train_loss_scalars
        self.imu_encoder = build_imu_encoder(config, dtype)
        self.video_encoder = build_video_encoder(config, dtype)
        self.imu_proj = ProjectionHead(
            m.imu_d_model, m.projection_hidden_dim, m.projection_dim, norm=m.head_norm, dtype=dtype
        )
        self.video_proj = ProjectionHead(
            m.video_d_model, m.projection_hidden_dim, m.projection_dim, norm=m.head_norm, dtype=dtype
        )
        self.temperature = nn.Parameter(torch.tensor(self.init_values["temperature"]))
        self.bias = nn.Parameter(torch.tensor(self.init_values["bias"]))
        self.record_use_dtypes()

    def forward(self, imu, video, *, train: bool = False, generator=None):
        """``imu`` or ``video`` may be ``None``: that tower does not run and its two
        outputs are left out (the zero-shot pass reads one projection at a time)."""
        t, b = self.temperature, self.bias
        if not self.train_loss_scalars:
            t, b = t.detach(), b.detach()
        out = {"logit_scale": t, "logit_bias": b}
        if imu is not None:
            imu_feat, out["imu_tokens"] = self.imu_encoder(imu, train=train, generator=generator)
            out["imu_proj"] = l2_normalize(self.imu_proj(imu_feat, train=train).float())
        if video is not None:
            video_feat, out["video_tokens"] = self.video_encoder(video, train=train)
            out["video_proj"] = l2_normalize(self.video_proj(video_feat, train=train).float())
        return out

    def encode_imu(self, imu, *, train: bool = False, generator=None):
        """The IMU encoder alone (``tpuhar/models/crossmodal.py: CrossModalModel.
        encode_imu``): ``(feat (B, imu_d_model) f32, tokens)``."""
        return self.imu_encoder(imu, train=train, generator=generator)


def _classifier_head(config, in_features: int, dtype) -> ClassifierHead:
    m = config.model
    return ClassifierHead(
        in_features, m.classifier_hidden_dims, m.num_classes, dropout=m.classifier_dropout,
        norm=m.head_norm, dtype=dtype,
    )


class IMUClassifier(MasterWeights):
    """IMU encoder + classifier head on the encoder's 128-d feature (``tpuhar/models/
    crossmodal.py: IMUClassifier``).

    ``forward(imu (B, C, T), *, train, generator)`` → ``(logits (B, num_classes) f32,
    feat (B, imu_d_model) f32)``; the feature is the embedding the OOD scorers read.
    With ``freeze_encoder`` (the linear probe) the encoder runs in eval mode (no dropout)
    and outside autograd, so its feature carries no gradient, as flax's
    ``stop_gradient`` gives.
    """

    def __init__(self, config, *, freeze_encoder: bool = False, dtype=None):
        super().__init__()
        m = config.model
        dtype = dtype or getattr(torch, m.compute_dtype)
        self.freeze_encoder = freeze_encoder
        self.imu_encoder = build_imu_encoder(config, dtype)
        self.classifier = _classifier_head(config, m.imu_d_model, dtype)
        self.record_use_dtypes()

    def forward(self, imu, *, train: bool = False, generator=None):
        if self.freeze_encoder:
            with torch.no_grad():
                feat, _ = self.imu_encoder(imu)
        else:
            feat, _ = self.imu_encoder(imu, train=train, generator=generator)
        return self.classifier(feat, train=train, generator=generator), feat


class VideoClassifier(MasterWeights):
    """Video-only clip classifier (``tpuhar/models/crossmodal.py: VideoClassifier``): the
    clip encoder, then the classifier head on its pooled ``video_d_model`` embedding.

    ``forward(video (B, T, H, W, 3) normalized float, *, train, generator)`` →
    ``(logits (B, num_classes) f32, emb (B, video_d_model) f32)``.
    """

    def __init__(self, config, *, dtype=None):
        super().__init__()
        m = config.model
        dtype = dtype or getattr(torch, m.compute_dtype)
        self.video_encoder = build_video_encoder(config, dtype)
        self.classifier = _classifier_head(config, m.video_d_model, dtype)
        self.record_use_dtypes()

    def forward(self, video, *, train: bool = False, generator=None):
        emb, _ = self.video_encoder(video, train=train)
        return self.classifier(emb, train=train, generator=generator), emb


class FusionClassifier(MasterWeights):
    """Both encoders emit token streams; ``fusion_layers`` rounds of two-way
    cross-attention mix them; the pooled streams, concatenated, are the fused
    embedding that feeds the classifier head and the OOD scores.

    ``forward(imu (B, C, T), video (B, T, ...), *, train, generator)`` → ``(logits (B,
    num_classes) f32, fused (B, 2·imu_d_model) f32)``. With ``train=True`` the encoders
    run in train mode and dropout (``imu_dropout`` in the cross-attention blocks,
    ``classifier_dropout`` in the head) draws its masks from ``generator``.
    """

    def __init__(self, config, *, dtype=None):
        super().__init__()
        m = config.model
        dtype = dtype or getattr(torch, m.compute_dtype)
        d = m.imu_d_model
        self.fusion_layers = m.fusion_layers
        self.imu_encoder = build_imu_encoder(config, dtype)
        self.video_encoder = build_video_encoder(config, dtype)
        self.video_to_fusion = nn.Linear(m.video_d_model, d, dtype=dtype)
        self.imu_to_fusion = nn.Linear(d, d, dtype=dtype)
        for i in range(m.fusion_layers):
            for stream in ("imu", "video"):
                self.add_module(
                    f"{stream}_xattn{i}",
                    CrossAttentionBlock(d, m.fusion_heads, 4 * d, dropout=m.imu_dropout, dtype=dtype),
                )
        self.classifier = _classifier_head(config, 2 * d, dtype)
        self.record_use_dtypes()

    def forward(self, imu, video, *, train: bool = False, generator=None):
        _, imu_tokens = self.imu_encoder(imu, train=train, generator=generator)
        _, video_tokens = self.video_encoder(video, train=train)
        return self._fuse(imu_tokens, video_tokens, train, generator)

    def fuse_with_tokens(self, imu, video_tokens, *, train: bool = False, generator=None):
        """``forward`` with video tokens ``(B, N, video_d_model)`` computed elsewhere (an
        int8 tower's, say). ``train`` and ``generator`` act as in ``forward``, and the
        masks are drawn in its order: with the same tokens and generator state the two
        give the same outputs and move a BatchNorm head's statistics alike. On a model
        with f32 masters, call it through ``forward_cast(imu, video_tokens,
        method="fuse_with_tokens", ...)``."""
        _, imu_tokens = self.imu_encoder(imu, train=train, generator=generator)
        return self._fuse(imu_tokens, video_tokens, train, generator)

    def _fuse(self, imu_tokens, video_tokens, train: bool = False, generator=None):
        hi = self.imu_to_fusion(imu_tokens)
        hv = self.video_to_fusion(video_tokens)
        for i in range(self.fusion_layers):
            hi, hv = (
                getattr(self, f"imu_xattn{i}")(hi, hv, train=train, generator=generator),
                getattr(self, f"video_xattn{i}")(hv, hi, train=train, generator=generator),
            )
        fused = torch.cat([hi.mean(dim=1), hv.mean(dim=1)], dim=-1).float()
        return self.classifier(fused, train=train, generator=generator), fused
