"""The ``tpu_cnn`` video tower at eval and the CNN branch of the video encoder
(``tpuhar/models/video.py``: ``TPUVideoCNN``, ``VideoEncoder``)."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.conv3x3 import conv3x3_bn_act, conv_nhwc, fold_bn
from ..ops.stem import pack_stem_weights
from .layers import BatchNorm

# backbone name → (widths, blocks per stage)
TPU_CNN_CONFIGS = {"tpu_cnn": ((256, 512), 1), "tpu_cnn_large": ((384, 512), 2)}


class ConvKernel(nn.Module):
    """An HWIO conv kernel, stored as flax's ``nn.Conv(use_bias=False)`` stores it."""

    def __init__(self, shape, *, dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)


class TPUVideoCNN(nn.Module):
    """Per-frame CNN at eval: a ``patch×patch`` patch-embed stem, residual 3×3 stages
    (both convs of each block through the fused conv kernel), a stride-2 conv between
    stages, global average pooling. Frames arrive NHWC ``(N, H, W, 3)`` or
    patch-major ``(N, H/p, W/p, p²·3)``; both use the same stem kernel."""

    def __init__(self, widths: Tuple[int, ...] = (256, 512), blocks_per_stage: int = 1, patch: int = 16, *, dtype=torch.float32):
        super().__init__()
        self.widths, self.blocks_per_stage, self.patch = tuple(widths), blocks_per_stage, patch
        self.stem_conv = ConvKernel((patch, patch, 3, widths[0]), dtype=dtype)
        self.stem_bn = BatchNorm(widths[0])
        prev = widths[0]
        for si, feats in enumerate(self.widths):
            if si > 0:
                self.add_module(f"down{si}_conv", ConvKernel((3, 3, prev, feats), dtype=dtype))
                self.add_module(f"down{si}_bn", BatchNorm(feats))
            for bi in range(blocks_per_stage):
                for part in "ab":
                    self.add_module(f"s{si}b{bi}{part}_conv", ConvKernel((3, 3, feats, feats), dtype=dtype))
                    self.add_module(f"s{si}b{bi}{part}_bn", BatchNorm(feats))
            prev = feats

    def forward(self, x):
        p, kernel = self.patch, self.stem_conv.kernel
        if x.shape[-1] == p * p * 3:  # patch-major: one K=p²·3 GEMM
            h = x @ pack_stem_weights(kernel)
        else:  # NHWC: the VALID stride-p conv
            h = conv_nhwc(x, kernel, stride=p, padding="VALID")
        h = torch.relu(self.stem_bn(h))
        for si in range(len(self.widths)):
            if si > 0:
                h = conv_nhwc(h, getattr(self, f"down{si}_conv").kernel, stride=2).contiguous()
                h = torch.relu(getattr(self, f"down{si}_bn")(h))
            for bi in range(self.blocks_per_stage):
                convs = [getattr(self, f"s{si}b{bi}{part}_conv").kernel for part in "ab"]
                bns = [getattr(self, f"s{si}b{bi}{part}_bn") for part in "ab"]
                sa, ba = fold_bn(bns[0].scale, bns[0].bias, bns[0].mean, bns[0].var)
                sb, bb = fold_bn(bns[1].scale, bns[1].bias, bns[1].mean, bns[1].var)
                h2 = conv3x3_bn_act(h, convs[0], sa, ba, relu=True)
                h = conv3x3_bn_act(h2, convs[1], sb, bb, residual=h, relu=True)
        return h.mean(dim=(1, 2))


class VideoEncoder(nn.Module):
    """CNN branch of the video encoder: frames folded into the batch, the tower, a
    ``projection`` Dense per frame, then the temporal mean.

    ``(B, T, ...)`` → ``(emb (B, video_d_model) f32, tokens (B, T, video_d_model))``.
    """

    def __init__(self, backbone: str = "tpu_cnn", video_d_model: int = 768, *, dtype=torch.float32):
        super().__init__()
        if backbone not in TPU_CNN_CONFIGS:
            raise NotImplementedError(f"video backbone {backbone!r} is not ported")
        widths, blocks = TPU_CNN_CONFIGS[backbone]
        self.dtype = dtype
        self.backbone = TPUVideoCNN(widths, blocks, dtype=dtype)
        self.projection = nn.Linear(widths[-1], video_d_model, dtype=dtype)

    def forward(self, x):
        B, T = x.shape[:2]
        feats = self.backbone(x.to(self.dtype).reshape(B * T, *x.shape[2:]))
        tokens = self.projection(feats.reshape(B, T, -1))
        return tokens.mean(dim=1).float(), tokens


def build_video_encoder(config, dtype) -> VideoEncoder:
    m = config.model
    return VideoEncoder(m.video_backbone, m.video_d_model, dtype=dtype)
