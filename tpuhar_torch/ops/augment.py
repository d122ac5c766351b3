"""IMU augmentation on the device: jitter and time warp (``tpuhar/ops/augment.py``).

Both act on featurized ``(B, C, T)`` windows inside the train step, with fresh draws
every step from an explicit ``torch.Generator`` on the windows' device. Each splits into
its draw and a deterministic core that takes the draw (``jitter_from_noise``,
``time_warp_from_offsets``), so the same draws can be fed to both packages. In a
data-parallel scope (``parallel.scope``) each draw is this rank's rows of the global
batch's draw.

- **jitter**: additive Gaussian noise scaled by ``jitter_strength`` (the windows are
  z-scored, so the strength is in units of a channel's std).
- **time warp**: a smooth monotone reparameterization of the time axis, built from a
  few Gaussian knot offsets interpolated to ``T``, applied by linear interpolation.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel import scope

KNOTS = 4  # the time warp's knot offsets per window


def jitter_from_noise(x: torch.Tensor, noise: torch.Tensor, strength: float) -> torch.Tensor:
    """``x + strength · noise``; ``noise`` is standard normal of ``x``'s shape."""
    if strength <= 0:
        return x
    return x + strength * noise


def jitter(x: torch.Tensor, strength: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Additive Gaussian noise on ``(B, C, T)`` windows."""
    if strength <= 0:
        return x
    noise = scope.draw_rows(lambda size: torch.randn(size, generator=generator, dtype=x.dtype, device=x.device), x.shape)
    return jitter_from_noise(x, noise, strength)


def _interp(t: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(t, xp, fp)`` for each row of ``fp`` ``(B, K)``: piecewise linear through
    the increasing knots ``xp`` ``(K,)``, held at the end values outside them."""
    i = torch.clamp(torch.searchsorted(xp, t, right=True), 1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[:, i - 1], fp[:, i]
    f = torch.addcmul(f0, ((t - x0) / (x1 - x0)).expand_as(f0), f1 - f0)
    f = torch.where(t < xp[0], fp[:, :1], f)
    return torch.where(t > xp[-1], fp[:, -1:], f)


def time_warp_from_offsets(x: torch.Tensor, offsets: torch.Tensor, strength: float) -> torch.Tensor:
    """Time warp of ``(B, C, T)`` windows by the knot offsets ``(B, knots)``.

    The offsets, placed at evenly spaced knots and interpolated linearly to ``T``, give
    each window a displacement curve; it is scaled so that its largest shift is
    ``strength · T / 4``, tapered by ``sin(π t / (T − 1))`` to 0 at both ends (the
    window's span stays fixed), and each output sample is read at ``t + shift`` by
    linear interpolation, clamped to the window."""
    if strength <= 0:
        return x
    B, C, T = x.shape
    knot_pos = torch.linspace(0.0, T - 1.0, offsets.shape[1], dtype=x.dtype, device=x.device)
    t = torch.arange(T, dtype=x.dtype, device=x.device)
    disp = _interp(t, knot_pos, offsets.to(x.dtype))  # (B, T)
    max_shift = strength * T / 4.0
    disp = disp / (disp.abs().amax(dim=1, keepdim=True) + 1e-8) * max_shift
    taper = torch.sin(math.pi * t / (T - 1.0))
    src = torch.clamp(t[None, :] + disp * taper[None, :], 0.0, T - 1.0)  # (B, T)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=T - 1)
    frac = (src - lo.to(x.dtype))[:, None, :]  # (B, 1, T)
    x_lo = torch.gather(x, 2, lo[:, None, :].expand(B, C, T))
    x_hi = torch.gather(x, 2, hi[:, None, :].expand(B, C, T))
    return x_lo * (1.0 - frac) + x_hi * frac


def time_warp(
    x: torch.Tensor, strength: float, generator: Optional[torch.Generator] = None, knots: int = KNOTS
) -> torch.Tensor:
    """Smooth monotone time warp of ``(B, C, T)`` windows (``time_warp_from_offsets`` of
    standard normal knot offsets)."""
    if strength <= 0:
        return x
    offsets = scope.draw_rows(lambda size: torch.randn(size, generator=generator, dtype=x.dtype, device=x.device),
                              (x.shape[0], knots))
    return time_warp_from_offsets(x, offsets, strength)


def augment_imu(x: torch.Tensor, config, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The configured augmentation chain on ``(B, C, T)`` windows, the time warp then the
    jitter, each drawing from ``generator`` in turn (the knot offsets, then the noise);
    the windows as they are when ``data.use_augmentation`` is off."""
    d = config.data
    if not d.use_augmentation:
        return x
    x = time_warp(x, float(d.time_warp_strength), generator)
    return jitter(x, float(d.jitter_strength), generator)
