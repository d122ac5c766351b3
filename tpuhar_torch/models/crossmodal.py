"""Cross-attention IMU+video fusion classifier (``tpuhar/models/crossmodal.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .imu import build_imu_encoder
from .layers import ClassifierHead, CrossAttentionBlock
from .video import build_video_encoder


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
