"""Video ops on the device (``tpuhar/ops/video.py``): uint8 clips → ImageNet-normalized
model input (with an optional space-to-depth on the uint8 pixels), bilinear resize and
the uniform frame selection."""
from __future__ import annotations

import torch
import torch.nn.functional as F

# torchvision ImageNet statistics
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_clip(
    video_u8: torch.Tensor, *, mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=torch.float32
) -> torch.Tensor:
    """uint8 ``(..., H, W, 3)`` → ``x · (1/255)/std − mean/std`` in ``dtype``.

    ``mean`` and ``std`` are sequences, or tensors of ``dtype`` on ``video_u8``'s device,
    which are used as they are: no host-to-device copy, so a CUDA graph can capture the
    call (``clip_stats``)."""
    mean = torch.as_tensor(mean, dtype=dtype, device=video_u8.device)
    std = torch.as_tensor(std, dtype=dtype, device=video_u8.device)
    return video_u8.to(dtype) * ((1.0 / 255.0) / std) + (-mean / std)


def clip_stats(device, dtype=torch.float32):
    """The ImageNet ``(mean, std)`` as tensors on ``device``, made once for
    ``normalize_clip``."""
    return tuple(torch.tensor(v, dtype=dtype, device=device) for v in (IMAGENET_MEAN, IMAGENET_STD))


def space_to_depth_clip(video: torch.Tensor, s: int) -> torch.Tensor:
    """``(B, T, H, W, C)`` → ``(B, T, H/s, W/s, C·s²)``, each output channel vector the
    ``s × s`` block's pixels in row-major order (a copy: do it on the uint8 pixels)."""
    B, T, H, W, C = video.shape
    x = video.reshape(B, T, H // s, s, W // s, s, C)
    return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T, H // s, W // s, s * s * C)


def prepare_clip(video_u8: torch.Tensor, *, s2d: int = 0, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC clip → normalized model input; with ``s2d > 1`` the uint8 pixels are
    rearranged first (``space_to_depth_clip``) and the ImageNet statistics tiled to the
    ``s²·3`` channels."""
    if s2d and s2d > 1:
        reps = s2d * s2d
        return normalize_clip(space_to_depth_clip(video_u8, s2d), mean=IMAGENET_MEAN * reps,
                              std=IMAGENET_STD * reps, dtype=dtype)
    return normalize_clip(video_u8, dtype=dtype)


def resize_clip(video: torch.Tensor, height: int, width: int, method: str = "bilinear") -> torch.Tensor:
    """``(B, T, H, W, C)`` clips resized to ``height × width`` as ``jax.image.resize``
    does: half-pixel centres (no corner alignment), a triangle filter widened when
    shrinking (antialiased), in f32 for integer input. Only ``"bilinear"``."""
    if method != "bilinear":
        raise ValueError(f"resize_clip takes method='bilinear', not {method!r}")
    B, T, H, W, C = video.shape
    x = video if video.is_floating_point() else video.float()
    if (H, W) == (height, width):
        return x
    x = x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).reshape(B, T, height, width, C)


def select_uniform_frames(total_frames: int, start_frame, window_frames: int, num_frames: int) -> torch.Tensor:
    """``num_frames`` int32 indices spread evenly (rounded half to even) from
    ``start_frame`` over ``window_frames`` frames, clipped to the video; ``start_frame``
    may be a 0-d tensor."""
    start = torch.clamp(torch.as_tensor(start_frame), 0, max(total_frames - 1, 0))
    end = torch.clamp(start + window_frames - 1, max=total_frames - 1)
    span = torch.clamp(end - start, min=0)
    frac = torch.arange(num_frames, dtype=torch.float32) / float(max(num_frames - 1, 1))
    idx = start + torch.round(frac * span).to(torch.int32)
    return torch.clamp(idx, 0, total_frames - 1).to(torch.int32)
