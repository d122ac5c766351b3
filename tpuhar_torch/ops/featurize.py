"""IMU featurization in plain PyTorch: unit conversion, median filter, z-score,
windowing, Fourier resampling and the STFT spectrogram.

Counterpart of ``tpuhar/ops/featurize.py``. Windows are time-major ``(..., T, C)``;
``featurize_windows`` returns ``(B, C, T)`` and is the plain version of the fused
kernel in ``ops/fused_window.py``. The sequence path (``masked_zscore_time``,
``window_slice_padded``, ``preprocess_sequence``) takes zero-padded sequences with
their valid lengths and a leading batch axis: one call featurizes a bucket of
sequences, where the JAX package maps a jitted function over them.
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


def masked_zscore_time(x: torch.Tensor, length: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Z-score of zero-padded ``(..., T, C)`` sequences over their first ``length`` rows
    (``length`` of shape ``(...)``): the statistics of ``zscore_time(x[:length])``, the
    shapes static. Rows at or past ``length`` come out normalized too, and the caller
    masks them."""
    T = x.shape[-2]
    length = torch.as_tensor(length, device=x.device)
    mask = (torch.arange(T, device=x.device) < length.unsqueeze(-1)).unsqueeze(-1).to(x.dtype)
    n = torch.clamp(length.to(x.dtype), min=1.0)[..., None, None]
    mean = (x * mask).sum(dim=-2, keepdim=True) / n
    var = (((x - mean) * mask) ** 2).sum(dim=-2, keepdim=True) / n
    return (x - mean) / (torch.sqrt(var) + eps)


def num_windows(length: int, window: int, stride: int) -> int:
    """Full windows over a length-``length`` sequence (0 if it is shorter than one)."""
    if length < window:
        return 0
    return (length - window) // stride + 1


def window_slice(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``(T, C)`` → ``(num_windows, window, C)``, the full windows every ``stride``
    samples; pad a sequence shorter than ``window`` first (``pad_to_window``)."""
    n = num_windows(x.shape[-2], window, stride)
    if n == 0:
        return x.new_zeros(x.shape[:-2] + (0, window, x.shape[-1]))
    return x.unfold(-2, window, stride).transpose(-1, -2)


def window_slice_padded(x: torch.Tensor, length: torch.Tensor, window: int, stride: int):
    """Windows of zero-padded ``(..., T, C)`` sequences of run-time lengths ``length``
    ``(...)``: ``(windows (..., max_n, window, C), n_valid (...) int32)``, ``max_n`` the
    windows of the padded buffer and ``n_valid`` those inside ``max(length, window)``,
    so that a short sequence padded to a window gives one (``pad_short_sequences``), an
    empty one none."""
    length = torch.as_tensor(length, device=x.device)
    windows = window_slice(x, window, stride)
    eff_len = torch.clamp(length, min=window)
    n_valid = torch.where(length > 0, torch.div(eff_len - window, stride, rounding_mode="floor") + 1, 0)
    return windows, n_valid.to(torch.int32)


def pad_to_window(x, window: int):
    """Zero-pad a too-short ``(T, C)`` numpy array to ``(window, C)`` (host helper)."""
    import numpy as np

    if x.shape[0] >= window:
        return x
    return np.vstack([x, np.zeros((window - x.shape[0], x.shape[1]), dtype=x.dtype)])


def fourier_resample(x: torch.Tensor, n_target: int) -> torch.Tensor:
    """FFT resampling of real ``(..., T, C)`` signals to ``n_target`` samples along time,
    as ``scipy.signal.resample`` does for real input: the spectrum cut or zero-extended,
    the Nyquist bin of an even length doubled (down) or halved (up)."""
    Nx = x.shape[-2]
    X = torch.fft.rfft(x, dim=-2)
    N = min(n_target, Nx)
    nyq = N // 2 + 1
    Y = X.new_zeros(x.shape[:-2] + (n_target // 2 + 1, x.shape[-1]))
    Y[..., :nyq, :] = X[..., :nyq, :]
    if N % 2 == 0:
        if n_target < Nx:
            Y[..., N // 2, :] *= 2.0
        elif n_target > Nx:
            Y[..., N // 2, :] *= 0.5
    y = torch.fft.irfft(Y, n=n_target, dim=-2)
    return (y * (n_target / Nx)).to(x.dtype)


def preprocess_sequence(
    raw: torch.Tensor,
    length: torch.Tensor,
    *,
    window: int,
    stride: int,
    kernel_size: int = 5,
    normalize: bool = True,
    racc: float = 16384.0,
    rgyro: float = 16.4,
):
    """Raw zero-padded sequences → their windows, on ``raw``'s device.

    ``raw`` is ``(..., T_bucket, 6)`` f32 raw counts, zero past each row's ``length``
    ``(...)``; returns ``(windows (..., max_windows, window, 6) f32, n_valid (...)
    int32)``. The offline chain: unit conversion, the median filter (the padding's
    zeros are scipy's implicit ones at the sequence's end), the z-score over the valid
    rows, the padding zeroed again (the reference pads short sequences after
    normalizing), then windows every ``stride``."""
    x = median_filter_time(raw_to_physical(raw, racc, rgyro), kernel_size)
    length = torch.as_tensor(length, device=x.device)
    if normalize:
        x = masked_zscore_time(x, length)
        mask = (torch.arange(x.shape[-2], device=x.device) < length.unsqueeze(-1)).unsqueeze(-1)
        x = x * mask.to(x.dtype)
    return window_slice_padded(x, length, window, stride)


def featurize_windows(
    raw_windows: torch.Tensor,
    *,
    kernel_size: int = 5,
    normalize: bool = True,
    racc: float = 16384.0,
    rgyro: float = 16.4,
    already_physical: bool = False,
) -> torch.Tensor:
    """Per-window featurization for inference: ``(B, T, C)`` raw → ``(B, C, T)``.

    With ``already_physical`` the windows are taken as already in g and deg/s: the unit
    scaling by ``racc`` and ``rgyro`` is skipped."""
    x = raw_windows if already_physical else raw_to_physical(raw_windows, racc, rgyro)
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
