"""The cells' inputs, made on the device from ``--seed``: raw IMU counts at the sensor's
range, uint8 clips, featurized IMU windows, the patch-major wire of the ``tpu_cnn``
stem. The same seed gives the same inputs; every seed gives inputs of the same sizes.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream ``keys`` of the run seeded ``seed``."""
    return int(np.random.SeedSequence([int(seed) % 2**64, *keys]).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, *keys: int, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def imu_counts(cfg: Mapping, batch: int, gen: torch.Generator) -> torch.Tensor:
    """``(B, T, 6)`` f32 int16 counts: acceleration N(0, 8192²) with 1 g (16384) on z,
    angular rate N(0, 820²)."""
    d = cfg["data"]
    x = torch.randn((batch, d["imu_window_size"], d["imu_channels"]), generator=gen, device=gen.device)
    sd = torch.tensor([8192.0] * 3 + [820.0] * 3, device=gen.device)
    g = torch.tensor([0.0, 0.0, 16384.0, 0.0, 0.0, 0.0], device=gen.device)
    return torch.clamp(torch.round(x * sd + g), -32768, 32767)


def clips(cfg: Mapping, batch: int, gen: torch.Generator) -> torch.Tensor:
    """``(B, T, H, W, 3)`` uint8 pixels, uniform on 0..255."""
    d = cfg["data"]
    H, W = d["video_resize"]
    shape = (batch, d["video_frames_per_window"], H, W, 3)
    return torch.randint(0, 256, shape, generator=gen, device=gen.device, dtype=torch.uint8)


def featurized_imu(cfg: Mapping, batch: int, gen: torch.Generator) -> torch.Tensor:
    """``(B, 6, T)`` f32 windows as the pretraining loader delivers them: N(0, 1)."""
    d = cfg["data"]
    return torch.randn((batch, d["imu_channels"], d["imu_window_size"]), generator=gen, device=gen.device)


def patch_major(clip: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC ``(..., H, W, C)`` → ``(..., H/p, W/p, p·p·C)``, each patch's pixels in
    (row, column, channel) order: the wire the folded ``tpu_cnn`` stem reads."""
    *lead, H, W, C = clip.shape
    x = clip.reshape(*lead, H // patch, patch, W // patch, patch * C).transpose(-3, -2)
    return x.reshape(*lead, H // patch, W // patch, patch * patch * C).contiguous()
