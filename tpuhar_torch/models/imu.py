"""The IMU encoders (``tpuhar/models/imu.py``): the PatchTST-like transformer over raw
patches, the same transformer over STFT frames, and the 1-D CNN.

Each takes featurized windows ``(B, C, T)`` and returns ``(embedding (B, d_model) f32,
tokens (B, N, d_model))``; its leaves carry flax's names and shapes.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.conv3x3 import conv_nlc
from ..ops.featurize import stft_featurize
from .layers import LN_EPS, BatchNorm, TransformerEncoderBlock
from .video import ConvKernel


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


class STFTTokenizer(nn.Module):
    """Per-channel projection of STFT frames: ``(B, C, F, bins)`` → ``(B, C·F, D)`` by
    the einsum ``bcfk,ckd->bcfd`` with a ``(C, bins, D)`` kernel and a ``(C, 1, D)``
    bias, flax's plain parameters."""

    def __init__(self, in_channels: int, n_bins: int, d_model: int, *, dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_channels, n_bins, d_model, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(in_channels, 1, d_model, dtype=dtype), requires_grad=False)

    def forward(self, spec):
        B, C, Fr, _ = spec.shape
        out = torch.einsum("bcfk,ckd->bcfd", spec.to(self.kernel.dtype), self.kernel) + self.bias
        return out.reshape(B, C * Fr, out.shape[-1])


class IMUSpectrogramEncoder(nn.Module):
    """The transformer trunk of ``IMUTransformerEncoder`` tokenized from log-magnitude
    STFT frames (``ops/featurize.stft_featurize``) instead of raw patches: a CLS token
    ~ N(0, 1) in front of the channel-major frame tokens, a positional table ~ N(0,
    0.02) over ``1 + C·F`` tokens (37 at T=250, ``nperseg`` 64, ``hop`` 32), post-norm
    blocks (dropout from ``generator`` with ``train=True``), a final LayerNorm; the CLS
    row is the embedding."""

    init_std = {"pos_encoding": 0.02}  # flax normal(0.02); read by bridge.init_params

    def __init__(
        self,
        in_channels: int = 6,
        window_size: int = 250,
        d_model: int = 128,
        num_heads: int = 8,
        num_layers: int = 4,
        dropout: float = 0.0,
        nperseg: int = 64,
        hop: int = 32,
        *,
        dtype=torch.float32,
    ):
        super().__init__()
        self.num_layers, self.nperseg, self.hop = num_layers, nperseg, hop
        frames = (window_size - nperseg) // hop + 1
        self.stft_tokenizer = STFTTokenizer(in_channels, nperseg // 2 + 1, d_model, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d_model, dtype=dtype), requires_grad=False)
        self.pos_encoding = nn.Parameter(
            torch.empty(1, 1 + in_channels * frames, d_model, dtype=dtype), requires_grad=False
        )
        for i in range(num_layers):
            self.add_module(
                f"block{i}",
                TransformerEncoderBlock(d_model, num_heads, 4 * d_model, dropout=dropout, dtype=dtype),
            )
        self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)

    def forward(self, x, *, train: bool = False, generator=None):
        spec = stft_featurize(x.transpose(-1, -2), nperseg=self.nperseg, hop=self.hop)
        tokens = self.stft_tokenizer(spec)
        B, _, D = tokens.shape
        tokens = torch.cat([self.cls_token.expand(B, 1, D), tokens], dim=1) + self.pos_encoding
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens, train=train, generator=generator)
        tokens = self.final_norm(tokens)
        return tokens[:, 0].float(), tokens


class IMUConvEncoder(nn.Module):
    """1-D CNN over time: for each width a conv (flax's ``nn.Conv``: ``kernel`` taps,
    stride 2, SAME padding, with bias), a BatchNorm (train mode with ``train=True``) and
    ReLU; then the ``proj`` Dense per frame and the mean over frames (32 frames at
    T=250). Returns ``(embedding (B, D) f32, frame tokens (B, T', D))``."""

    def __init__(
        self,
        in_channels: int = 6,
        channels: Sequence[int] = (64, 128, 128),
        kernel: int = 9,
        d_model: int = 128,
        *,
        dtype=torch.float32,
    ):
        super().__init__()
        self.dtype, self.depth = dtype, len(channels)
        prev = in_channels
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", ConvKernel((kernel, prev, ch), bias=True, dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(ch))
            prev = ch
        self.proj = nn.Linear(prev, d_model, dtype=dtype)

    def forward(self, x, *, train: bool = False, generator=None):
        h = x.transpose(-1, -2).to(self.dtype)
        for i in range(self.depth):
            conv = getattr(self, f"conv{i}")
            h = conv_nlc(h, conv.kernel, 2, bias=conv.bias)
            h = torch.relu(getattr(self, f"bn{i}")(h, train=train))
        tokens = self.proj(h)
        return tokens.mean(dim=1).float(), tokens


def build_imu_encoder(config, dtype) -> nn.Module:
    """The IMU encoder of ``config``, keyed as the JAX package keys it: the 1-D CNN
    where ``model.imu_encoder`` is "cnn", else the spectrogram transformer where
    ``data.imu_featurizer`` is "stft", else the transformer over raw patches."""
    m, d = config.model, config.data
    if m.imu_encoder == "cnn":
        return IMUConvEncoder(
            d.imu_channels, tuple(m.imu_cnn_channels), m.imu_cnn_kernel, m.imu_d_model, dtype=dtype,
        )
    if d.imu_featurizer == "stft":
        return IMUSpectrogramEncoder(
            in_channels=d.imu_channels,
            window_size=d.imu_window_size,
            d_model=m.imu_d_model,
            num_heads=m.imu_nhead,
            num_layers=m.imu_num_layers,
            dropout=m.imu_dropout,
            nperseg=d.stft_nperseg,
            hop=d.stft_hop,
            dtype=dtype,
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
