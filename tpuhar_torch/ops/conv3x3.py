"""Fused 3×3 SAME conv + folded BatchNorm + residual + ReLU on square NHWC planes.

``conv3x3_bn_act`` computes ``act(conv3x3_same(x) · scale + bias [+ residual])``. A
tensor on the CPU takes the plain path (``conv3x3_bn_act_reference``: ``F.conv2d``,
then the affine, residual and ReLU in f32); a CUDA tensor launches the bf16 kernel of
``csrc/conv3x3.cu``, the port of ``tpuhar/ops/conv3x3.py: conv3x3_bn_act``, or raises.
``conv3x3_bn_act.launches`` counts the kernel's launches. Unlike the TPU function
there is no quiet fallback for shapes the kernel does not take.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _ext


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """BatchNorm parameters and running stats → (scale', bias') in f32."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    return s, bias.float() - mean.float() * s


def conv3x3_bn_act_reference(
    x: torch.Tensor,
    kernel: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    relu: bool = True,
) -> torch.Tensor:
    """Plain version: the conv in ``x``'s dtype, the epilogue in f32, out in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1).float() * scale.float() + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def conv3x3_bn_act(
    x: torch.Tensor,
    kernel: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    residual: Optional[torch.Tensor] = None,
    relu: bool = True,
) -> torch.Tensor:
    """Fused ``act(conv3x3_same(x) · scale + bias [+ residual])``.

    Args:
      x: ``(N, S, S, C)`` NHWC activations.
      kernel: ``(3, 3, C, C_out)`` HWIO weights (flax ``nn.Conv`` layout).
      scale, bias: ``(C_out,)`` folded BatchNorm, applied in f32.
      residual: optional ``(N, S, S, C_out)``, added before the activation.
      relu: apply ReLU last.
    """
    if x.device.type == "cpu":
        return conv3x3_bn_act_reference(x, kernel, scale, bias, residual, relu)
    N, S, S2, C = x.shape
    C_out = kernel.shape[-1]
    tensors = {"x": x, "kernel": kernel}
    if residual is not None:
        tensors["residual"] = residual
    for name, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"conv3x3 kernel: {name} must be a contiguous bfloat16 CUDA tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"conv3x3 kernel: {name} must be 16-byte aligned")
    if S != S2:
        raise ValueError(f"conv3x3 kernel: square planes only, got {(S, S2)}")
    if C % 16 or C_out % 16:
        raise ValueError(f"conv3x3 kernel: C={C} and C_out={C_out} must be multiples of 16")
    if tuple(kernel.shape) != (3, 3, C, C_out):
        raise ValueError(f"conv3x3 kernel: weights {tuple(kernel.shape)} != {(3, 3, C, C_out)}")
    if residual is not None and tuple(residual.shape) != (N, S, S, C_out):
        raise ValueError(f"conv3x3 kernel: residual {tuple(residual.shape)} != {(N, S, S, C_out)}")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.shape != (C_out,) or bias.shape != (C_out,):
        raise ValueError("conv3x3 kernel: scale and bias must be (C_out,)")
    out = torch.empty((N, S, S, C_out), dtype=x.dtype, device=x.device)
    lib = _ext.library()
    with torch.cuda.device(x.device):
        status = lib.tpuhar_conv3x3_bn_act(
            x.data_ptr(), kernel.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            N * S * S, S, C, C_out, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _ext.check(status, "tpuhar_conv3x3_bn_act")
    conv3x3_bn_act.launches += 1
    return out


conv3x3_bn_act.launches = 0
