"""What the per-layer metric files share: the traced window's idle share, the model
FLOPs of the window's completed work against the peak, and a kernel's share of its
roofline from its device time in the trace. Each returns ``None`` where the run holds
nothing to read (no trace, no launch of the kernel)."""
from __future__ import annotations

from typing import Optional

from . import counts


def device_idle_pct(run) -> Optional[float]:
    return None if run.trace is None else run.trace.idle_pct()


def serve_mfu_pct(run) -> Optional[float]:
    """Model FLOPs of the windows done ÷ the window's seconds ÷ the bf16 peak."""
    if not run.window.done:
        return None
    return counts.mfu_pct(counts.fusion_flops(run.cfg) * run.window.units, run.window.seconds)


def train_mfu_pct(run) -> Optional[float]:
    """Three forwards of model FLOPs a sample done ÷ the window's seconds ÷ the peak."""
    if not run.window.done:
        return None
    return counts.mfu_pct(counts.train_step_flops(run.cfg, 1) * run.window.units, run.window.seconds)


def roofline_pct(run, pattern: str, bound_s_each: float, launches_per_unit: int = 1) -> Optional[float]:
    """100 × (launches ÷ ``launches_per_unit``) × ``bound_s_each`` ÷ the device time of
    the kernels named by ``pattern`` in the traced window."""
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_seconds(pattern)
    if launches == 0 or launches % launches_per_unit or seconds <= 0:
        return None
    return 100.0 * (launches // launches_per_unit) * bound_s_each / seconds
