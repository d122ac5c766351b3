"""IMU featurization in plain PyTorch: unit conversion, median filter, z-score, and
the STFT spectrogram.

Counterpart of ``tpuhar/ops/featurize.py`` (the serving subset and
``stft_featurize``). Windows are time-major ``(..., T, C)``; ``featurize_windows``
returns ``(B, C, T)``. This is the plain version of the fused kernel in
``ops/fused_window.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def raw_to_physical(raw: torch.Tensor, racc: float = 16384.0, rgyro: float = 16.4):
    """Raw 6-channel counts ``(..., T, 6)`` → acc/Racc [g], gyro/Rgyro [deg/s]."""
    scale = torch.tensor(
        [1.0 / racc] * 3 + [1.0 / rgyro] * 3, dtype=raw.dtype, device=raw.device
    )
    return raw * scale


def median_filter_time(x: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Per-channel median filter along time of ``(..., T, C)``, as
    ``scipy.signal.medfilt``: zero-padded edges, even kernels bumped to the next odd
    size, ``kernel_size <= 1`` the identity."""
    if kernel_size <= 1:
        return x
    k = kernel_size + 1 if kernel_size % 2 == 0 else kernel_size
    T = x.shape[-2]
    xp = F.pad(x, (0, 0, k // 2, k // 2))
    taps = torch.stack([xp[..., i : i + T, :] for i in range(k)], dim=0)
    return taps.median(dim=0).values  # k is odd: the true median


def zscore_time(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-channel z-score over time of ``(..., T, C)`` (population std + eps)."""
    mean = x.mean(dim=-2, keepdim=True)
    std = x.std(dim=-2, correction=0, keepdim=True) + eps
    return (x - mean) / std


def featurize_windows(
    raw_windows: torch.Tensor,
    *,
    kernel_size: int = 5,
    normalize: bool = True,
    racc: float = 16384.0,
    rgyro: float = 16.4,
) -> torch.Tensor:
    """Per-window featurization for inference: ``(B, T, C)`` raw → ``(B, C, T)``."""
    x = raw_to_physical(raw_windows, racc, rgyro)
    x = median_filter_time(x, kernel_size)
    if normalize:
        x = zscore_time(x)
    return x.transpose(-1, -2)


def stft_featurize(x: torch.Tensor, nperseg: int = 64, hop: int = 32, *, log_eps: float = 1e-6) -> torch.Tensor:
    """Per-channel log-magnitude spectrogram of ``(..., T, C)``: frames of ``nperseg``
    samples every ``hop``, each times a Hann window, ``log(|rfft| + log_eps)``.

    Returns ``(..., C, F, nperseg//2 + 1)`` with ``F = (T − nperseg)//hop + 1``. The
    window is numpy's ``hanning``, the symmetric one (``periodic=False``; torch's
    default is the periodic window)."""
    frames = x.unfold(-2, nperseg, hop)  # (..., F, C, nperseg)
    win = torch.hann_window(nperseg, periodic=False, dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(frames * win, dim=-1)  # (..., F, C, bins)
    return torch.log(spec.abs() + log_eps).transpose(-3, -2).to(x.dtype)
