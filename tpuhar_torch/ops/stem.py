"""Patch-major clip layout for the patch-embed stem (``tpuhar/ops/stem.py``).

The host ships each clip patch-major, ``(..., H/p, W/p, p²·3)``, so that the
``tpu_cnn`` stem is one K=768 GEMM against the packed ``(p²·3, C0)`` kernel.
"""
from __future__ import annotations

import numpy as np


def pack_stem_weights(kernel_hwio):
    """``(p, p, C_in, C0)`` HWIO kernel → ``(p²·C_in, C0)`` GEMM matrix, rows in the
    order ``((row · p) + col) · C_in + ch`` that ``to_patch_major`` produces."""
    p, p2, cin, c0 = kernel_hwio.shape
    if p != p2:
        raise ValueError(f"square patch kernels only, got {tuple(kernel_hwio.shape)}")
    return kernel_hwio.reshape(p * p * cin, c0)


def to_patch_major(frames: np.ndarray, patch: int = 16) -> np.ndarray:
    """HOST-side layout shuffle: ``(..., H, W, C)`` uint8 → ``(..., H/p, W/p, p²·C)``."""
    *lead, H, W, C = frames.shape
    Hp, Wp = H // patch, W // patch
    if Hp * patch != H or Wp * patch != W:
        raise ValueError(f"frames {frames.shape} do not tile into {patch}x{patch} patches")
    x = frames.reshape(*lead, Hp, patch, Wp, patch * C)
    x = np.moveaxis(x, -3, -2)  # (..., Hp, Wp, patch, patch·C)
    return np.ascontiguousarray(x).reshape(*lead, Hp, Wp, patch * patch * C)
