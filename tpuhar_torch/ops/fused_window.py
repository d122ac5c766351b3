"""Fused per-window IMU featurization: the Hopper kernel and its dispatch.

``featurize_windows_auto`` is the serving featurizer. A tensor on the CPU takes the
plain path (``ops.featurize.featurize_windows``); a CUDA tensor launches the kernel of
``csrc/fused_window.cu``, the port of ``tpuhar/ops/fused_window.py:
featurize_windows_pallas``, or raises. ``featurize_windows_auto.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _ext
from .featurize import featurize_windows

CHANNELS = 6  # channels 0-2 accelerometer, 3-5 gyroscope
THREADS = 32 * CHANNELS  # one warp a channel
MAX_LANE = 32  # samples a lane holds in the register form: it takes T <= 32 * MAX_LANE
PAD = 2  # zeros before and after each channel's row in the register form
TILE = 1024  # samples of one tile the tiled form stages in shared memory
SMEM_MAX = 232448  # the shared memory one block can use on an H100 (227 KB)


def median_taps(kernel_size: int) -> int:
    """The taps of the plain version's median filter: even sizes are bumped to the next
    odd one, ``kernel_size <= 1`` is no filter (1 tap)."""
    if kernel_size <= 1:
        return 1
    return kernel_size + 1 if kernel_size % 2 == 0 else kernel_size


class LaunchPlan(NamedTuple):
    """How ``csrc/fused_window.cu`` launches on ``(B, T, 6)`` windows: ``form``
    ``"registers"`` or ``"tiled"``; ``blocks`` and ``threads`` (one block a window, one
    warp a channel); ``smem_bytes`` of shared memory a block; ``per_lane``, the samples
    a lane holds in registers (0 in the tiled form, which keeps none)."""

    form: str
    blocks: int
    threads: int
    smem_bytes: int
    per_lane: int


def launch_plan(B: int, T: int, kernel_size: int) -> LaunchPlan:
    """The kernel's form and launch for ``B`` windows of ``T`` samples, as its entry
    picks them from ``T``: the register form while a lane's share of a channel,
    rounded up to a power of two, fits ``MAX_LANE`` samples, its rows padded by ``PAD``
    zeros on either side; else the tiled form, whose tile's span is ``min(T, TILE + k -
    1)`` samples of every channel."""
    if T <= 32 * MAX_LANE:
        per_lane = 1
        while 32 * per_lane < T:
            per_lane *= 2
        return LaunchPlan("registers", B, THREADS, CHANNELS * (32 * per_lane + 2 * PAD) * 4, per_lane)
    span = min(T, TILE + median_taps(kernel_size) - 1)
    return LaunchPlan("tiled", B, THREADS, span * CHANNELS * 4, 0)


def check_fused_window_operand(shape, dtype, contiguous: bool, kernel_size: int) -> None:
    """Raise ``ValueError`` on a window the kernel does not take, from its shape, type,
    contiguity and the filter size alone: a contiguous float32 ``(B, T, 6)`` tensor with
    ``B, T >= 1``, and the block's shared memory (``launch_plan``) within ``SMEM_MAX``:
    a tile's span of ``min(T, TILE + k - 1)`` samples in the tiled form, so any ``k`` up
    to 8661 taps, and any ``k`` at all for ``T <= 9685``."""
    if dtype != torch.float32 or len(shape) != 3:
        raise ValueError(f"need a 3-D float32 CUDA tensor, got {dtype} {tuple(shape)}")
    B, T, C = shape
    if C != CHANNELS or not contiguous or B < 1 or T < 1:
        raise ValueError(f"need a contiguous (B, T, {CHANNELS}) window, got {tuple(shape)}")
    if launch_plan(B, T, kernel_size).smem_bytes > SMEM_MAX:
        raise ValueError(f"a {kernel_size}-tap median over {T} samples exceeds the kernel's shared memory")


def featurize_windows_auto(
    raw_windows: torch.Tensor,
    *,
    kernel_size: int = 5,
    normalize: bool = True,
    racc: float = 16384.0,
    rgyro: float = 16.4,
) -> torch.Tensor:
    """Serving featurization: ``(B, T, 6)`` raw counts → ``(B, 6, T)`` f32.

    On a CUDA tensor the host work per call is kept small, since the kernel takes a few
    microseconds: the operand check on the shape's plain ints, one read of the current
    stream, and a switch of the current device only when ``x`` lies on another. Nothing
    waits for the device, so a CUDA graph can capture the call."""
    x = raw_windows
    if not x.is_cuda:
        if x.device.type == "cpu":
            return featurize_windows(x, kernel_size=kernel_size, normalize=normalize, racc=racc, rgyro=rgyro)
        raise ValueError(f"need a CUDA tensor, got one on {x.device}")
    shape = x.shape
    check_fused_window_operand(shape, x.dtype, x.is_contiguous(), kernel_size)
    B, T, C = shape
    out = x.new_empty((B, C, T))
    index = x.get_device()
    # the raw pointer of the device's current stream: current_stream(index).cuda_stream,
    # without building a Stream object (a few microseconds a call)
    args = (
        x.data_ptr(), out.data_ptr(), B, T, C, 1.0 / racc, 1.0 / rgyro, median_taps(kernel_size),
        TILE, int(normalize), torch._C._cuda_getCurrentRawStream(index),
    )
    launch = _ext.library().tpuhar_fused_window
    if index == torch.cuda.current_device():
        status = launch(*args)
    else:
        with torch.cuda.device(index):
            status = launch(*args)
    _ext.check(status, "tpuhar_fused_window")
    featurize_windows_auto.launches += 1
    return out


featurize_windows_auto.launches = 0
