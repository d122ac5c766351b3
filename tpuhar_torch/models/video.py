"""The video towers at eval and the video encoder (``tpuhar/models/video.py``): the
``tpu_cnn`` CNN (``TPUVideoCNN``) and the VideoMAE-architecture ViT (``VideoViT``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import conv3x3_bn_act, conv_nhwc, fold_bn
from ..ops.stem import pack_stem_weights
from .layers import LN_EPS, BatchNorm, PreNormBlock

# backbone name → (widths, blocks per stage)
TPU_CNN_CONFIGS = {"tpu_cnn": ((256, 512), 1), "tpu_cnn_large": ((384, 512), 2)}
# backbone name → (depth, d_model, heads): the HF VideoMAE size ladder; tiny is for tests
VIT_CONFIGS = {
    "videomae_large": (24, 1024, 16),
    "videomae_base": (12, 768, 12),
    "videomae_small": (12, 384, 6),
    "videomae_tiny": (4, 192, 3),
}
TUBELET = (2, 16, 16)


class ConvKernel(nn.Module):
    """A conv kernel (``(..., C_in, C_out)``, spatial axes first) and optional bias,
    stored as flax's ``nn.Conv`` stores them."""

    def __init__(self, shape, *, bias: bool = False, dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)
        if bias:
            self.bias = nn.Parameter(torch.empty(shape[-1], dtype=dtype), requires_grad=False)


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


class TubeletEmbed(nn.Module):
    """3D tubelet patch embedding ``(B, T, H, W, 3)`` → ``(B, N, d_model)``: flax's
    VALID stride == kernel ``nn.Conv`` as one GEMM. Patches are taken in the kernel's
    ``(kt, kh, kw, C)`` order and tokens in ``(t, h, w)`` order
    (``tpuhar/ops/quant_vit._patchify``)."""

    def __init__(self, d_model: int, *, dtype=torch.float32):
        super().__init__()
        self.proj = ConvKernel((*TUBELET, 3, d_model), bias=True, dtype=dtype)

    def forward(self, x):
        kt, kh, kw = TUBELET
        B, T, H, W, C = x.shape
        t, h, w = T // kt, H // kh, W // kw  # VALID: a remainder is dropped
        x = x[:, : t * kt, : h * kh, : w * kw].reshape(B, t, kt, h, kh, w, kw, C)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, t * h * w, kt * kh * kw * C)
        kernel = self.proj.kernel
        return F.linear(x, kernel.reshape(-1, kernel.shape[-1]).T, self.proj.bias)


class VideoViT(nn.Module):
    """VideoMAE-architecture video transformer at eval: tubelet embedding, a learned
    positional table over ``num_tokens`` tokens, pre-norm blocks, an optional final
    LayerNorm, then mean pooling.

    ``(B, T, H, W, 3)`` → ``(emb (B, d_model) f32, tokens (B, N, d_model))``.
    """

    init_std = {"pos_encoding": 0.02}  # flax normal(0.02); read by bridge.init_params

    def __init__(
        self,
        num_tokens: int,
        depth: int = 12,
        d_model: int = 768,
        num_heads: int = 12,
        *,
        use_final_norm: bool = True,
        use_flash: bool = False,
        gelu_approximate: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.depth, self.use_final_norm = depth, use_final_norm
        self.tubelet = TubeletEmbed(d_model, dtype=dtype)
        self.pos_encoding = nn.Parameter(torch.empty(1, num_tokens, d_model, dtype=dtype), requires_grad=False)
        for i in range(depth):
            self.add_module(f"block{i}", PreNormBlock(
                d_model, num_heads, 4 * d_model, use_flash=use_flash,
                gelu_approximate=gelu_approximate, dtype=dtype,
            ))
        if use_final_norm:
            self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)

    def forward(self, x, *, train: bool = False):
        tokens = self.tubelet(x) + self.pos_encoding
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens, train=train)
        if self.use_final_norm:
            tokens = self.final_norm(tokens)
        return tokens.mean(dim=1).float(), tokens


class VideoEncoder(nn.Module):
    """The video encoder: a ``tpu_cnn`` tower or a ViT, then a ``projection`` Dense.

    CNN: frames folded into the batch, the tower, the projection per frame, then the
    temporal mean. ViT (``num_tokens`` sizes its positional table): the ``vit``
    submodule, then one projection applied to the pooled embedding and to the tokens.
    ``(B, T, ...)`` → ``(emb (B, video_d_model) f32, tokens (B, N, video_d_model))``.
    Training (``train=True``) takes a normalized float NHWC clip with nothing folded
    into the weights, and is ported for the ViT only.
    """

    def __init__(
        self,
        backbone: str = "tpu_cnn",
        video_d_model: int = 768,
        *,
        num_tokens: int = 0,
        use_flash: bool = False,
        use_final_norm: bool = True,
        gelu_approximate: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.is_vit = backbone in VIT_CONFIGS
        if self.is_vit:
            depth, width, heads = VIT_CONFIGS[backbone]
            self.vit = VideoViT(
                num_tokens, depth, width, heads, use_final_norm=use_final_norm,
                use_flash=use_flash, gelu_approximate=gelu_approximate, dtype=dtype,
            )
        elif backbone in TPU_CNN_CONFIGS:
            widths, blocks = TPU_CNN_CONFIGS[backbone]
            width = widths[-1]
            self.backbone = TPUVideoCNN(widths, blocks, dtype=dtype)
        else:
            raise NotImplementedError(f"video backbone {backbone!r} is not ported")
        self.projection = nn.Linear(width, video_d_model, dtype=dtype)

    def forward(self, x, *, train: bool = False):
        x = x.to(self.dtype)
        if self.is_vit:
            emb, tokens = self.vit(x, train=train)
            return self.projection(emb.to(self.dtype)).float(), self.projection(tokens)
        if train:
            raise NotImplementedError("training the tpu_cnn towers is not ported")
        B, T = x.shape[:2]
        feats = self.backbone(x.reshape(B * T, *x.shape[2:]))
        tokens = self.projection(feats.reshape(B, T, -1))
        return tokens.mean(dim=1).float(), tokens


def build_video_encoder(config, dtype) -> VideoEncoder:
    m, d = config.model, config.data
    backbone = m.video_backbone
    # the reference routes any name holding "videomae" or "/" to HuggingFace (quirk
    # Q10); such names map onto the native ViT
    if ("/" in backbone or "videomae" in backbone.lower()) and backbone not in VIT_CONFIGS:
        backbone = "videomae_base"
    H, W = d.video_resize
    kt, kh, kw = TUBELET
    return VideoEncoder(
        backbone,
        m.video_d_model,
        num_tokens=(d.video_frames_per_window // kt) * (H // kh) * (W // kw),
        use_flash=m.use_flash_attention,
        use_final_norm=bool(m.video_use_final_norm),
        gelu_approximate=bool(m.gelu_approximate),
        dtype=dtype,
    )
