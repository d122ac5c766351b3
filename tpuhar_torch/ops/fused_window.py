"""Fused per-window IMU featurization: the Hopper kernel and its dispatch.

``featurize_windows_auto`` is the serving featurizer. A tensor on the CPU takes the
plain path (``ops.featurize.featurize_windows``); a CUDA tensor launches the kernel of
``csrc/fused_window.cu``, the port of ``tpuhar/ops/fused_window.py:
featurize_windows_pallas``, or raises. ``featurize_windows_auto.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from .. import _ext
from .featurize import featurize_windows

CHANNELS = 6  # channels 0-2 accelerometer, 3-5 gyroscope
TILE = 1024  # samples of one tile the kernel stages in shared memory
SMEM_MAX = 232448  # the shared memory one block can use on an H100 (227 KB)


def median_taps(kernel_size: int) -> int:
    """The taps of the plain version's median filter: even sizes are bumped to the next
    odd one, ``kernel_size <= 1`` is no filter (1 tap)."""
    if kernel_size <= 1:
        return 1
    return kernel_size + 1 if kernel_size % 2 == 0 else kernel_size


def check_fused_window_operand(shape, dtype, contiguous: bool, kernel_size: int) -> None:
    """Raise ``ValueError`` on a window the kernel does not take, from its shape, type,
    contiguity and the filter size alone: a contiguous float32 ``(B, T, 6)`` tensor with
    ``B, T >= 1``, and a tile's span of ``min(T, TILE + k - 1)`` samples within one
    block's shared memory (any ``k`` up to 8661 taps, and any ``k`` at all for ``T <=
    9685``)."""
    if dtype != torch.float32 or len(shape) != 3:
        raise ValueError(f"need a 3-D float32 CUDA tensor, got {dtype} {tuple(shape)}")
    B, T, C = shape
    if C != CHANNELS or not contiguous or B < 1 or T < 1:
        raise ValueError(f"need a contiguous (B, T, {CHANNELS}) window, got {tuple(shape)}")
    if min(T, TILE + median_taps(kernel_size) - 1) * C * 4 > SMEM_MAX:
        raise ValueError(f"a {kernel_size}-tap median over {T} samples exceeds the kernel's shared memory")


def featurize_windows_auto(
    raw_windows: torch.Tensor,
    *,
    kernel_size: int = 5,
    normalize: bool = True,
    racc: float = 16384.0,
    rgyro: float = 16.4,
) -> torch.Tensor:
    """Serving featurization: ``(B, T, 6)`` raw counts → ``(B, 6, T)`` f32."""
    if raw_windows.device.type == "cpu":
        return featurize_windows(
            raw_windows, kernel_size=kernel_size, normalize=normalize,
            racc=racc, rgyro=rgyro,
        )
    x = raw_windows
    if not x.is_cuda:
        raise ValueError(f"need a CUDA tensor, got one on {x.device}")
    check_fused_window_operand(x.shape, x.dtype, x.is_contiguous(), kernel_size)
    B, T, C = x.shape
    out = torch.empty((B, C, T), dtype=torch.float32, device=x.device)
    lib = _ext.library()
    with torch.cuda.device(x.device):
        status = lib.tpuhar_fused_window(
            x.data_ptr(), out.data_ptr(), B, T, C, 1.0 / racc, 1.0 / rgyro,
            median_taps(kernel_size), TILE, int(normalize),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _ext.check(status, "tpuhar_fused_window")
    featurize_windows_auto.launches += 1
    return out


featurize_windows_auto.launches = 0
