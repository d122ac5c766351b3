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
_SMEM_LIMIT = 48 * 1024  # the kernel's window + filtered rows, without an opt-in


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
    if kernel_size not in (1, 4, 5):  # 4 bumps to 5 like the plain version
        raise NotImplementedError("the fused window kernel supports k in {1, 4, 5}")
    x = raw_windows
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"need a 3-D float32 CUDA tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
    B, T, C = x.shape
    if C != CHANNELS or not x.is_contiguous():
        raise ValueError(f"need a contiguous (B, T, {CHANNELS}) window, got {tuple(x.shape)}")
    if 2 * T * C * 4 > _SMEM_LIMIT:
        raise ValueError(f"window of {T} samples exceeds the kernel's shared memory")
    out = torch.empty((B, C, T), dtype=torch.float32, device=x.device)
    lib = _ext.library()
    with torch.cuda.device(x.device):
        status = lib.tpuhar_fused_window(
            x.data_ptr(), out.data_ptr(), B, T, C, 1.0 / racc, 1.0 / rgyro,
            int(kernel_size > 1), int(normalize),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _ext.check(status, "tpuhar_fused_window")
    featurize_windows_auto.launches += 1
    return out


featurize_windows_auto.launches = 0
