"""The video towers and the video encoder (``tpuhar/models/video.py``): the
``tpu_cnn`` CNN (``TPUVideoCNN``), ResNet-18, MobileNetV2, the test-size
``TinyVideoCNN`` and the VideoMAE-architecture ViT (``VideoViT``), each in eval and in
train mode. Every tower's leaves carry flax's names and shapes (HWIO conv kernels;
BatchNorm ``scale``/``bias``/``mean``/``var``), so ``bridge`` loads a JAX tree as it
is. The convs of every tower but the ``tpu_cnn``'s serving blocks run through
``ops/conv3x3.conv_nhwc`` (cuDNN on the card), as the JAX package runs them through
XLA's."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.conv3x3 import conv3x3_bn_act, conv_nhwc, fold_bn, max_pool_nhwc
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


def relu6(x):
    """``min(relu(x), 6)``, MobileNetV2's activation."""
    return torch.clamp(torch.relu(x), max=6.0)


class TPUVideoCNN(nn.Module):
    """Per-frame CNN: a ``patch×patch`` patch-embed stem, residual 3×3 stages, a
    stride-2 SAME conv between stages, global average pooling. Frames arrive NHWC
    ``(N, H, W, 3)`` or patch-major ``(N, H/p, W/p, p²·3)``; both use the same stem
    kernel.

    At eval both convs of each block go through the fused conv kernel with their
    BatchNorms folded in (``conv3x3_bn_act``). ``train=True`` is the JAX package's
    unfused branch: every conv through ``conv_nhwc``, each BatchNorm in train mode
    (batch statistics, running ones moved), then ``relu(h2 + residual)``."""

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

    def forward(self, x, *, train: bool = False):
        p, kernel = self.patch, self.stem_conv.kernel
        if x.shape[-1] == p * p * 3:  # patch-major: one K=p²·3 GEMM
            h = x @ pack_stem_weights(kernel)
        else:  # NHWC: the VALID stride-p conv
            h = conv_nhwc(x, kernel, stride=p, padding="VALID")
        h = torch.relu(self.stem_bn(h, train=train))
        for si in range(len(self.widths)):
            if si > 0:
                h = conv_nhwc(h, getattr(self, f"down{si}_conv").kernel, stride=2).contiguous()
                h = torch.relu(getattr(self, f"down{si}_bn")(h, train=train))
            for bi in range(self.blocks_per_stage):
                convs = [getattr(self, f"s{si}b{bi}{part}_conv").kernel for part in "ab"]
                bns = [getattr(self, f"s{si}b{bi}{part}_bn") for part in "ab"]
                if train:
                    h2 = torch.relu(bns[0](conv_nhwc(h, convs[0]), train=True))
                    h = torch.relu(bns[1](conv_nhwc(h2, convs[1]), train=True) + h)
                    continue
                sa, ba = fold_bn(bns[0].scale, bns[0].bias, bns[0].mean, bns[0].var)
                sb, bb = fold_bn(bns[1].scale, bns[1].bias, bns[1].mean, bns[1].var)
                h2 = conv3x3_bn_act(h, convs[0], sa, ba, relu=True)
                h = conv3x3_bn_act(h2, convs[1], sb, bb, residual=h, relu=True)
        return h.mean(dim=(1, 2))


class BasicBlock(nn.Module):
    """ResNet's basic block: two 3×3 convs padded (1, 1), each with a BatchNorm, and
    the residual through a 1×1 ``downsample_conv`` + BatchNorm where the shape changes
    (a stride or a new width: block 0 of layers 1-3), as flax creates those leaves."""

    def __init__(self, in_features: int, features: int, stride: int = 1, *, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.conv1 = ConvKernel((3, 3, in_features, features), dtype=dtype)
        self.bn1 = BatchNorm(features)
        self.conv2 = ConvKernel((3, 3, features, features), dtype=dtype)
        self.bn2 = BatchNorm(features)
        self.downsample = stride != 1 or in_features != features
        if self.downsample:
            self.downsample_conv = ConvKernel((1, 1, in_features, features), dtype=dtype)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x, *, train: bool = False):
        h = conv_nhwc(x, self.conv1.kernel, self.stride, [(1, 1), (1, 1)])
        h = torch.relu(self.bn1(h, train=train))
        h = self.bn2(conv_nhwc(h, self.conv2.kernel, 1, [(1, 1), (1, 1)]), train=train)
        residual = x
        if self.downsample:
            residual = self.downsample_bn(conv_nhwc(x, self.downsample_conv.kernel, self.stride), train=train)
        return torch.relu(h + residual)


class ResNet18(nn.Module):
    """torchvision's resnet18 without its FC head, per frame, NHWC: the 7×7 stride-2
    stem, BatchNorm, ReLU, a 3×3 stride-2 max-pool, four layers of two basic blocks
    (64, 128, 256, 512), global average pooling to ``(N, 512)``."""

    LAYERS = ((64, 2), (128, 2), (256, 2), (512, 2))

    def __init__(self, *, dtype=torch.float32):
        super().__init__()
        self.stem_conv = ConvKernel((7, 7, 3, 64), dtype=dtype)
        self.stem_bn = BatchNorm(64)
        prev = 64
        self.blocks = []
        for li, (feats, blocks) in enumerate(self.LAYERS):
            for bi in range(blocks):
                stride = 2 if (bi == 0 and li > 0) else 1
                self.add_module(f"layer{li}_{bi}", BasicBlock(prev, feats, stride, dtype=dtype))
                self.blocks.append(f"layer{li}_{bi}")
                prev = feats

    def forward(self, x, *, train: bool = False):
        h = conv_nhwc(x, self.stem_conv.kernel, 2, [(3, 3), (3, 3)])
        h = max_pool_nhwc(torch.relu(self.stem_bn(h, train=train)), 3, 2, 1)
        for name in self.blocks:
            h = getattr(self, name)(h, train=train)
        return h.mean(dim=(1, 2))


class InvertedResidual(nn.Module):
    """MobileNetV2's inverted residual: a 1×1 ``expand_conv`` to ``in·expand``
    channels (none where ``expand`` is 1), the depthwise 3×3 ``dw_conv`` (flax's
    ``(3, 3, 1, hidden)`` kernel, one group a channel) at ``stride``, the 1×1
    ``project_conv``, each with a BatchNorm, ReLU6 after the first two; the input is
    added back where the stride is 1 and the width is kept."""

    def __init__(self, in_features: int, features: int, stride: int, expand: int, *, dtype=torch.float32):
        super().__init__()
        hidden = in_features * expand
        self.stride, self.expand, self.hidden = stride, expand, hidden
        self.residual = stride == 1 and in_features == features
        if expand != 1:
            self.expand_conv = ConvKernel((1, 1, in_features, hidden), dtype=dtype)
            self.expand_bn = BatchNorm(hidden)
        self.dw_conv = ConvKernel((3, 3, 1, hidden), dtype=dtype)
        self.dw_bn = BatchNorm(hidden)
        self.project_conv = ConvKernel((1, 1, hidden, features), dtype=dtype)
        self.project_bn = BatchNorm(features)

    def forward(self, x, *, train: bool = False):
        h = x
        if self.expand != 1:
            h = relu6(self.expand_bn(conv_nhwc(h, self.expand_conv.kernel), train=train))
        h = conv_nhwc(h, self.dw_conv.kernel, self.stride, [(1, 1), (1, 1)], groups=self.hidden)
        h = relu6(self.dw_bn(h, train=train))
        h = self.project_bn(conv_nhwc(h, self.project_conv.kernel), train=train)
        return h + x if self.residual else h


# (expand, features, repeats, stride) of each MobileNetV2 stage
MOBILENET_V2_SETTINGS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


class MobileNetV2(nn.Module):
    """torchvision's mobilenet_v2 ``.features`` per frame, NHWC: a 3×3 stride-2 stem
    to 32 channels, the 17 inverted residuals of ``MOBILENET_V2_SETTINGS``, the 1×1
    ``head_conv`` to 1280, each conv with a BatchNorm and ReLU6; global average
    pooling to ``(N, 1280)``."""

    def __init__(self, *, dtype=torch.float32):
        super().__init__()
        self.stem_conv = ConvKernel((3, 3, 3, 32), dtype=dtype)
        self.stem_bn = BatchNorm(32)
        prev, self.depth = 32, 0
        for expand, feats, repeats, stride in MOBILENET_V2_SETTINGS:
            for r in range(repeats):
                self.add_module(f"ir{self.depth}", InvertedResidual(
                    prev, feats, stride if r == 0 else 1, expand, dtype=dtype,
                ))
                prev, self.depth = feats, self.depth + 1
        self.head_conv = ConvKernel((1, 1, prev, 1280), dtype=dtype)
        self.head_bn = BatchNorm(1280)

    def forward(self, x, *, train: bool = False):
        h = relu6(self.stem_bn(conv_nhwc(x, self.stem_conv.kernel, 2, [(1, 1), (1, 1)]), train=train))
        for i in range(self.depth):
            h = getattr(self, f"ir{i}")(h, train=train)
        h = relu6(self.head_bn(conv_nhwc(h, self.head_conv.kernel), train=train))
        return h.mean(dim=(1, 2))


class TinyVideoCNN(nn.Module):
    """Three 3×3 stride-2 SAME convs with bias (16, 32, 64 channels), each followed
    by ReLU, then global average pooling: the JAX package's test-size tower."""

    WIDTHS = (16, 32, 64)

    def __init__(self, *, dtype=torch.float32):
        super().__init__()
        prev = 3
        for i, ch in enumerate(self.WIDTHS):
            self.add_module(f"conv{i}", ConvKernel((3, 3, prev, ch), bias=True, dtype=dtype))
            prev = ch

    def forward(self, x, *, train: bool = False):
        h = x
        for i in range(len(self.WIDTHS)):
            conv = getattr(self, f"conv{i}")
            h = torch.relu(conv_nhwc(h, conv.kernel, 2, bias=conv.bias))
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
    """VideoMAE-architecture video transformer: tubelet embedding, a learned
    positional table over ``num_tokens`` tokens, pre-norm blocks, an optional final
    LayerNorm, then mean pooling.

    ``remat`` is the JAX package's ``nn.remat(PreNormBlock)``: in train mode each block
    keeps only its input, and its forward runs again inside the backward
    (``torch.utils.checkpoint``). The blocks hold no dropout and no BatchNorm, so a
    recompute draws nothing and moves no statistic, and the RNG state is not saved.

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
        remat: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.depth, self.use_final_norm, self.remat = depth, use_final_norm, remat
        self.tubelet = TubeletEmbed(d_model, dtype=dtype)
        self.pos_encoding = nn.Parameter(torch.empty(1, num_tokens, d_model, dtype=dtype), requires_grad=False)
        for i in range(depth):
            self.add_module(f"block{i}", PreNormBlock(
                d_model, num_heads, 4 * d_model, use_flash=use_flash,
                gelu_approximate=gelu_approximate, dtype=dtype,
            ))
        stateful = [name for name, m in self.named_modules()
                    if isinstance(m, BatchNorm) or getattr(m, "dropout_rate", 0.0) > 0.0]
        if stateful:  # under remat a recompute would draw new masks or move the statistics again
            raise TypeError(f"the ViT blocks must hold no dropout or BatchNorm, found {stateful}")
        if use_final_norm:
            self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)

    def forward(self, x, *, train: bool = False):
        tokens = self.tubelet(x) + self.pos_encoding
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if self.remat and train and torch.is_grad_enabled():
                tokens = _rematerialized(block, tokens)
            else:
                tokens = block(tokens, train=train)
        if self.use_final_norm:
            tokens = self.final_norm(tokens)
        return tokens.mean(dim=1).float(), tokens


def _rematerialized(block: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """``block(tokens, train=True)`` that keeps no activation of its own: the backward
    runs the block again. The recompute reads the parameters the block holds now,
    which under ``MasterWeights.forward_cast`` are the compute-dtype casts that
    ``functional_call`` put in place and takes out again before the backward, so it
    calls the block with those very tensors."""
    params = dict(block.named_parameters())

    def run(t):
        return torch.func.functional_call(block, params, (t,), {"train": True})

    return checkpoint(run, tokens, use_reentrant=False, preserve_rng_state=False)


# CNN backbone name → the width of its per-frame feature
CNN_FEATURE_DIMS = {
    "resnet18": 512,
    "mobilenet_v2": 1280,
    "tiny_cnn": 64,
    "tpu_cnn": 512,
    "tpu_cnn_large": 512,
}


def _cnn_backbone(backbone: str, dtype) -> nn.Module:
    if backbone in TPU_CNN_CONFIGS:
        widths, blocks = TPU_CNN_CONFIGS[backbone]
        return TPUVideoCNN(widths, blocks, dtype=dtype)
    if backbone == "resnet18":
        return ResNet18(dtype=dtype)
    if backbone == "mobilenet_v2":
        return MobileNetV2(dtype=dtype)
    if backbone == "tiny_cnn":
        return TinyVideoCNN(dtype=dtype)
    raise ValueError(f"Unknown video backbone: {backbone}")


class VideoEncoder(nn.Module):
    """The video encoder: a CNN tower (``CNN_FEATURE_DIMS``) or a ViT, then a
    ``projection`` Dense.

    CNN: frames folded into the batch, the tower, the projection per frame, then the
    temporal mean. ViT (``num_tokens`` sizes its positional table): the ``vit``
    submodule, then one projection applied to the pooled embedding and to the tokens.
    ``(B, T, ...)`` → ``(emb (B, video_d_model) f32, tokens (B, N, video_d_model))``.
    Training (``train=True``) takes a normalized float NHWC clip with nothing folded
    into the weights; its BatchNorms use the batch's statistics and move their running
    ones.
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
        remat: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.is_vit = backbone in VIT_CONFIGS
        if self.is_vit:
            depth, width, heads = VIT_CONFIGS[backbone]
            self.vit = VideoViT(
                num_tokens, depth, width, heads, use_final_norm=use_final_norm,
                use_flash=use_flash, gelu_approximate=gelu_approximate, remat=remat, dtype=dtype,
            )
        else:
            self.backbone = _cnn_backbone(backbone, dtype)
            width = CNN_FEATURE_DIMS[backbone]
        self.projection = nn.Linear(width, video_d_model, dtype=dtype)

    def forward(self, x, *, train: bool = False):
        x = x.to(self.dtype)
        if self.is_vit:
            emb, tokens = self.vit(x, train=train)
            return self.projection(emb.to(self.dtype)).float(), self.projection(tokens)
        B, T = x.shape[:2]
        feats = self.backbone(x.reshape(B * T, *x.shape[2:]), train=train)
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
        remat=bool(m.remat_video),
        dtype=dtype,
    )
