"""PatchTST-like IMU encoder (``tpuhar/models/imu.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .layers import LN_EPS, TransformerEncoderBlock


class PatchEmbedding(nn.Module):
    """Channel-independent patch embedding: ``(B, C, L)`` → patches ``(B, C, N, P)``
    → a distinct ``(P, D)`` projection per channel → ``(B, C, N, D)``."""

    def __init__(self, in_channels: int, patch_size: int, stride: int, d_model: int, *, dtype=torch.float32):
        super().__init__()
        self.patch_size, self.stride = patch_size, stride
        self.kernel = nn.Parameter(
            torch.empty(in_channels, patch_size, d_model, dtype=dtype), requires_grad=False
        )
        self.bias = nn.Parameter(
            torch.empty(in_channels, 1, d_model, dtype=dtype), requires_grad=False
        )

    def forward(self, x):
        B, C, L = x.shape
        P = self.patch_size
        n = (L - P) // self.stride + 1
        if self.stride == P:  # a reshape; the tail past n·P samples is dropped
            patches = x[:, :, : n * P].reshape(B, C, n, P)
        else:
            idx = (torch.arange(n, device=x.device) * self.stride)[:, None] + torch.arange(P, device=x.device)
            patches = x[:, :, idx]
        return torch.einsum("bcnp,cpd->bcnd", patches.to(self.kernel.dtype), self.kernel) + self.bias


class IMUTransformerEncoder(nn.Module):
    """Patch embedding, a CLS token in front of the channel-major tokens, a learned
    positional table, post-norm blocks and a final LayerNorm.

    Returns ``(cls_embedding (B, D) f32, tokens (B, 1 + C·N, D))``.
    ``replicate_pos_truncation`` reproduces quirk Q1: the table is sized
    ``N + 1`` and the token stream is cut to it. ``dropout`` acts in the blocks with
    ``train=True``, its masks drawn from ``generator``.
    """

    def __init__(
        self,
        in_channels: int = 6,
        window_size: int = 250,
        patch_size: int = 16,
        stride: int = 16,
        d_model: int = 128,
        num_heads: int = 8,
        num_layers: int = 4,
        replicate_pos_truncation: bool = False,
        dropout: float = 0.0,
        *,
        dtype=torch.float32,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.patch_embed = PatchEmbedding(in_channels, patch_size, stride, d_model, dtype=dtype)
        n = (window_size - patch_size) // stride + 1
        pos_len = n + 1 if replicate_pos_truncation else in_channels * n + 1
        self.cls_token = nn.Parameter(torch.empty(1, 1, d_model, dtype=dtype), requires_grad=False)
        self.pos_encoding = nn.Parameter(torch.empty(1, pos_len, d_model, dtype=dtype), requires_grad=False)
        for i in range(num_layers):
            self.add_module(
                f"block{i}",
                TransformerEncoderBlock(d_model, num_heads, 4 * d_model, dropout=dropout, dtype=dtype),
            )
        self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)

    def forward(self, x, *, train: bool = False, generator=None):
        patches = self.patch_embed(x)
        B, C, N, D = patches.shape
        tokens = torch.cat([self.cls_token.expand(B, 1, D), patches.reshape(B, C * N, D)], dim=1)
        pos_len = min(tokens.shape[1], self.pos_encoding.shape[1])
        tokens = tokens[:, :pos_len] + self.pos_encoding[:, :pos_len]
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens, train=train, generator=generator)
        tokens = self.final_norm(tokens)
        return tokens[:, 0].float(), tokens


def build_imu_encoder(config, dtype) -> IMUTransformerEncoder:
    """The transformer IMU encoder of ``config`` (the only IMU encoder ported)."""
    m, d = config.model, config.data
    if m.imu_encoder != "transformer" or d.imu_featurizer != "raw":
        raise NotImplementedError(
            f"IMU encoder {m.imu_encoder!r} / featurizer {d.imu_featurizer!r} is not ported"
        )
    return IMUTransformerEncoder(
        in_channels=d.imu_channels,
        window_size=d.imu_window_size,
        patch_size=m.imu_patch_size,
        stride=m.imu_stride,
        d_model=m.imu_d_model,
        num_heads=m.imu_nhead,
        num_layers=m.imu_num_layers,
        replicate_pos_truncation=m.replicate_pos_truncation,
        dropout=m.imu_dropout,
        dtype=dtype,
    )
