"""uint8 clips → ImageNet-normalized model input (``tpuhar/ops/video.py``)."""
from __future__ import annotations

import torch

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


def prepare_clip(video_u8: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC clip → normalized model input (the unfolded serving path)."""
    return normalize_clip(video_u8, dtype=dtype)
