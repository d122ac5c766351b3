"""Composite models (``tpuhar/models/crossmodal.py``): the cross-modal contrastive
model that pretraining trains, the cross-attention IMU+video fusion classifier that
the serving forwards run, and the IMU classifier that IMU-only serving runs."""
from __future__ import annotations

import math

import torch
from torch import nn

from .imu import build_imu_encoder
from .layers import ClassifierHead, CrossAttentionBlock, ProjectionHead, l2_normalize
from .video import build_video_encoder


class CrossModalModel(nn.Module):
    """IMU and video encoders, a projection head each, unit-norm embeddings and the live
    SigLIP scalars ``temperature`` (log-temperature, log 10 at init) and ``bias`` (−10).

    ``forward(imu (B, C, T), video (B, T, H, W, 3) normalized float, *, train, generator)``
    → ``{"imu_proj", "video_proj"}`` ``(B, projection_dim)`` f32 unit-norm,
    ``"logit_scale"``/``"logit_bias"`` (detached with ``train_loss_scalars=False``, as
    flax's ``stop_gradient``) and ``"imu_tokens"``/``"video_tokens"``.

    The modules are built in ``dtype`` (the compute dtype); ``use_dtypes`` records each
    parameter's dtype as built, so that a training copy can keep f32 master weights and
    run ``forward_cast``, which casts each to that dtype at use.
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
        self.use_dtypes = {name: p.dtype for name, p in self.named_parameters()}

    def forward(self, imu, video, *, train: bool = False, generator=None):
        imu_feat, imu_tokens = self.imu_encoder(imu, train=train, generator=generator)
        video_feat, video_tokens = self.video_encoder(video, train=train)
        ip = self.imu_proj(imu_feat, train=train).float()
        vp = self.video_proj(video_feat, train=train).float()
        t, b = self.temperature, self.bias
        if not self.train_loss_scalars:
            t, b = t.detach(), b.detach()
        return {
            "imu_proj": l2_normalize(ip),
            "video_proj": l2_normalize(vp),
            "logit_scale": t,
            "logit_bias": b,
            "imu_tokens": imu_tokens,
            "video_tokens": video_tokens,
        }

    def forward_cast(self, *args, **kwargs):
        """``forward`` with every parameter cast to its ``use_dtypes`` entry at use: on a
        model whose parameters were made f32 masters (``.float()``), the modules compute
        in the dtype they were built in and the gradients reach the f32 leaves."""
        params = {name: p.to(self.use_dtypes[name]) for name, p in self.named_parameters()}
        return torch.func.functional_call(self, params, args, kwargs)


class IMUClassifier(nn.Module):
    """IMU encoder + classifier head on the encoder's 128-d feature (``tpuhar/models/
    crossmodal.py: IMUClassifier``), the eval forward only.

    ``forward(imu (B, C, T))`` → ``(logits (B, num_classes) f32, feat (B, imu_d_model)
    f32)``; the feature is the embedding the OOD scorers read.
    """

    def __init__(self, config, *, dtype=None):
        super().__init__()
        m = config.model
        dtype = dtype or getattr(torch, m.compute_dtype)
        self.imu_encoder = build_imu_encoder(config, dtype)
        self.classifier = ClassifierHead(
            m.imu_d_model, m.classifier_hidden_dims, m.num_classes, norm=m.head_norm, dtype=dtype
        )

    def forward(self, imu):
        feat, _ = self.imu_encoder(imu)
        return self.classifier(feat), feat


class FusionClassifier(nn.Module):
    """Both encoders emit token streams; ``fusion_layers`` rounds of two-way
    cross-attention mix them; the pooled streams, concatenated, are the fused
    embedding that feeds the classifier head and the OOD scores.

    ``forward(imu (B, C, T), video (B, T, ...))`` → ``(logits (B, num_classes) f32,
    fused (B, 2·imu_d_model) f32)``.
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
                    CrossAttentionBlock(d, m.fusion_heads, 4 * d, dtype=dtype),
                )
        self.classifier = ClassifierHead(
            2 * d, m.classifier_hidden_dims, m.num_classes, norm=m.head_norm, dtype=dtype
        )

    def forward(self, imu, video):
        _, imu_tokens = self.imu_encoder(imu)
        _, video_tokens = self.video_encoder(video)
        return self._fuse(imu_tokens, video_tokens)

    def fuse_with_tokens(self, imu, video_tokens):
        """Forward with video tokens ``(B, N, video_d_model)`` computed elsewhere."""
        _, imu_tokens = self.imu_encoder(imu)
        return self._fuse(imu_tokens, video_tokens)

    def _fuse(self, imu_tokens, video_tokens):
        hi = self.imu_to_fusion(imu_tokens)
        hv = self.video_to_fusion(video_tokens)
        for i in range(self.fusion_layers):
            hi, hv = (
                getattr(self, f"imu_xattn{i}")(hi, hv),
                getattr(self, f"video_xattn{i}")(hv, hi),
            )
        fused = torch.cat([hi.mean(dim=1), hv.mean(dim=1)], dim=-1).float()
        return self.classifier(fused), fused
