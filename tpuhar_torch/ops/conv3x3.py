"""Fused 3×3 SAME convs on square NHWC planes: bf16 with folded BatchNorm, and int8.

``conv3x3_bn_act`` computes ``act(conv3x3_same(x) · scale + bias [+ residual])``. A
tensor on the CPU takes the plain path (``conv3x3_bn_act_reference``: ``F.conv2d``,
then the affine, residual and ReLU in f32); a CUDA tensor launches the bf16 kernel of
``csrc/conv3x3.cu``, the port of ``tpuhar/ops/conv3x3.py: conv3x3_bn_act``, for f32
operands the f32 kernel of ``csrc/conv3x3_f32.cu`` (``conv3x3_bn_act_f32``: split-TF32
products on the tensor cores, its weights repacked by ``pack_conv3x3_f32``), or raises.

``conv3x3_i8`` is its int8 form, which also takes the place of the XLA int8 convs of
the JAX package's quantized tower (its ``ops/quant.int8_conv``, stride 1 and 2):
``act(acc · scale + bias [+ residual · res_scale])``, requantized to int8 or stored
f32, with XLA's SAME padding or explicit ``(lo, hi)`` pairs (ResNet-18's ``(1, 1)``,
which at stride 2 is not SAME). The CPU takes ``conv3x3_i8_reference``; a CUDA tensor
launches the ``wgmma`` s8 kernel of ``csrc/conv3x3_i8.cu`` or raises.

Each wrapper's ``.launches`` counts its kernel's launches. Unlike the TPU function
there is no quiet fallback for shapes a kernel does not take.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .. import _ext


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: ``max((⌈S/s⌉−1)·s + k − S, 0)`` split
    low ``⌊p/2⌋`` / high ``⌈p/2⌉`` (at 14² stride 2: 0 before, 1 after)."""
    pad = max((-(-size // stride) - 1) * stride + k - size, 0)
    return pad // 2, pad - pad // 2


Padding = Union[str, Sequence[Tuple[int, int]]]


def conv_pads(spatial: Sequence[int], window: Sequence[int], stride: int, padding: Padding) -> List[Tuple[int, int]]:
    """flax's ``padding`` of a conv or pool as one ``(lo, hi)`` pair per spatial axis:
    ``"SAME"`` (XLA's split, ``same_padding``), ``"VALID"`` (none) or the pairs
    themselves (``[(1, 1), (1, 1)]``, which at stride 2 is not SAME: at 56² SAME
    pads (0, 1))."""
    if padding == "SAME":
        return [same_padding(s, k, stride) for s, k in zip(spatial, window)]
    if padding == "VALID":
        return [(0, 0)] * len(spatial)
    if isinstance(padding, str) or len(padding) != len(spatial):
        raise ValueError(f"padding must be 'SAME', 'VALID' or {len(spatial)} (lo, hi) pairs, got {padding!r}")
    return [(int(lo), int(hi)) for lo, hi in padding]


def _conv_channels_first(xc, weight, stride: int, pads, groups: int, bias):
    """``F.conv1d``/``F.conv2d`` of a channels-first ``xc`` with ``(lo, hi)`` ``pads``
    per spatial axis: symmetric pads go to the conv itself, others through ``F.pad``
    first (zeros, as XLA pads)."""
    conv = F.conv2d if xc.dim() == 4 else F.conv1d
    if all(lo == hi for lo, hi in pads):
        return conv(xc, weight, bias, stride=stride, padding=tuple(lo for lo, _ in pads), groups=groups)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad takes the last axis first
    return conv(F.pad(xc, flat), weight, bias, stride=stride, groups=groups)


def conv_nhwc(x, kernel, stride: int = 1, padding: Padding = "SAME", *, groups: int = 1, bias=None):
    """flax's ``nn.Conv`` on NHWC ``x`` with an HWIO ``kernel`` ``(kh, kw, C/groups,
    C_out)``, in ``x``'s dtype: ``padding`` as ``conv_pads`` reads it,
    ``feature_group_count=groups`` (MobileNetV2's depthwise conv: ``(3, 3, 1, C)``,
    ``groups=C``) and an optional ``(C_out,)`` bias."""
    pads = conv_pads(x.shape[1:3], kernel.shape[:2], stride, padding)
    y = _conv_channels_first(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), stride, pads, groups, bias)
    return y.permute(0, 2, 3, 1)


def conv_nlc(x, kernel, stride: int = 1, padding: Padding = "SAME", *, bias=None):
    """flax's 1-D ``nn.Conv`` on ``(N, L, C)`` ``x`` with a ``(k, C, C_out)`` kernel and
    an optional bias, in ``x``'s dtype. SAME may pad unevenly: at L=250, k=9, stride 2
    it pads (3, 4)."""
    pads = conv_pads(x.shape[1:2], kernel.shape[:1], stride, padding)
    return _conv_channels_first(x.transpose(1, 2), kernel.permute(2, 1, 0), stride, pads, 1, bias).transpose(1, 2)


def max_pool_nhwc(x, window: int, stride: int, pad: int):
    """flax's ``nn.max_pool(x, (window, window), (stride, stride), [(pad, pad)] * 2)`` on
    NHWC ``x``: the padding is −inf, as ``F.max_pool2d``'s is."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, pad).permute(0, 2, 3, 1)


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


CONV_K_CHUNK = 64  # input channels the bf16 kernel multiplies per step: C is a multiple


def check_conv3x3_shapes(x_shape, kernel_shape, residual_shape=None) -> None:
    """Raise ``ValueError`` on shapes the bf16 kernel does not take: ``x`` is
    ``(N, S, S, C)`` with ``C`` a multiple of 64 (one 128-byte row of bf16 per pixel
    and tap), the weights ``(3, 3, C, C_out)`` with ``C_out`` a multiple of 8 (16-byte
    stores), the residual ``(N, S, S, C_out)``."""
    if len(x_shape) != 4:
        raise ValueError(f"conv3x3 kernel: x must be (N, S, S, C), got {tuple(x_shape)}")
    N, S, S2, C = x_shape
    if S != S2:
        raise ValueError(f"conv3x3 kernel: square planes only, got {(S, S2)}")
    if len(kernel_shape) != 4 or tuple(kernel_shape[:3]) != (3, 3, C):
        raise ValueError(f"conv3x3 kernel: weights {tuple(kernel_shape)} != (3, 3, {C}, C_out)")
    C_out = kernel_shape[3]
    if C % CONV_K_CHUNK or C_out % 8 or min(C, C_out) <= 0:
        raise ValueError(
            f"conv3x3 kernel: C={C} must be a multiple of {CONV_K_CHUNK} and C_out={C_out} of 8"
        )
    if residual_shape is not None and tuple(residual_shape) != (N, S, S, C_out):
        raise ValueError(f"conv3x3 kernel: residual {tuple(residual_shape)} != {(N, S, S, C_out)}")
    if N * S * S >= 2**31:
        raise ValueError(f"conv3x3 kernel: {N * S * S} output rows exceed 2^31")


def check_conv3x3_f32_shapes(x_shape, kernel_shape, residual_shape=None) -> None:
    """Raise ``ValueError`` on shapes the f32 kernel does not take: ``x`` ``(N, S, S,
    C)``, the weights ``(3, 3, C, C_out)``, the residual ``(N, S, S, C_out)``, fewer than
    2^31 output rows; any C and C_out."""
    if len(x_shape) != 4 or x_shape[1] != x_shape[2]:
        raise ValueError(f"conv3x3 f32 kernel: x must be (N, S, S, C), got {tuple(x_shape)}")
    N, S, _, C = x_shape
    if len(kernel_shape) != 4 or tuple(kernel_shape[:3]) != (3, 3, C) or min(N, S, C, kernel_shape[3]) <= 0:
        raise ValueError(f"conv3x3 f32 kernel: weights {tuple(kernel_shape)} != (3, 3, {C}, C_out)")
    if residual_shape is not None and tuple(residual_shape) != (N, S, S, kernel_shape[3]):
        raise ValueError(f"conv3x3 f32 kernel: residual {tuple(residual_shape)} != {(N, S, S, kernel_shape[3])}")
    if N * S * S >= 2**31:
        raise ValueError(f"conv3x3 f32 kernel: {N * S * S} output rows exceed 2^31")


CONV_F32_K_CHUNK = 32  # input channels the f32 kernel takes per step: C is padded to it
CONV_F32_N_TILE = 128  # output channels per block of the f32 kernel: C_out is padded to it
_F32_EXP = 0x7F800000  # the f32 exponent's bits
_TF32_KEEP = -0x2000  # 0xFFFFE000 as int32: the 19 bits TF32 keeps


def _tf32_round(v: torch.Tensor, nan: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` (``nan``: its NaNs) rounded to TF32 at bit 13, as int32 bit patterns: to
    nearest, ties away from zero (an add on the magnitude's bits); inf keeps its bits, a
    NaN stays a NaN in its top 19 bits, and a finite value that would round to inf is cut
    instead. The same recipe as ``csrc/conv3x3_f32.cu``'s ``tf32_round``."""
    u = v.view(torch.int32)
    r = (torch.where(nan, 0, u) + 0x1000) & _TF32_KEEP  # no NaN in the add: no int32 overflow
    r = torch.where((r & _F32_EXP) == _F32_EXP, u & _TF32_KEEP, r)  # inf, or a cut at the top
    return torch.where(nan, (u | 0x400000) & _TF32_KEEP, r)


def split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``v`` as two TF32 values in f32 tensors (low 13 mantissa bits zero), the
    operands of the f32 kernel's split products: ``hi`` is ``v`` rounded to TF32 (to
    nearest, ties away from zero), ``lo`` is ``v − hi`` (exact in f32) rounded the same
    way, so ``|v − hi − lo| ≤ 2⁻²²·|v|`` for ``|v| ≥ 2⁻¹¹⁵`` (below it TF32's subnormal
    step bounds what is left: at most 2⁻¹³⁷). inf and NaN keep their class in ``hi`` with
    ``lo = 0``; a finite value that would round to inf is cut."""
    v = v.float().contiguous()
    hi = _tf32_round(v, torch.isnan(v)).view(torch.float32)
    rest = torch.where(torch.isfinite(v), v - hi, 0.0)
    lo = ((rest.view(torch.int32) + 0x1000) & _TF32_KEEP).view(torch.float32)  # finite and small
    return hi, lo


def pack_conv3x3_f32(kernel_hwio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(3, 3, C, C_out)`` f32 HWIO kernel → ``(w_hi, w_lo)``, the two
    ``(C_out_pad, 9·C_pad)`` K-major halves the f32 kernel reads (``split_tf32`` of the
    weights): row ``n`` is output channel ``n``'s K run in the order ``(dy·3 + dx)·C_pad
    + c``, zero past ``C`` and past ``C_out``; ``C_pad`` is ``C`` rounded up to 32 and
    ``C_out_pad`` is ``C_out`` rounded up to 128, so that every box the kernel loads
    lies inside the matrix."""
    kh, kw, c, c_out = kernel_hwio.shape
    c_pad = -(-c // CONV_F32_K_CHUNK) * CONV_F32_K_CHUNK
    c_out_pad = -(-c_out // CONV_F32_N_TILE) * CONV_F32_N_TILE
    w = kernel_hwio.float().reshape(kh * kw, c, c_out).permute(2, 0, 1)  # (C_out, 9, C)
    w = F.pad(w, (0, c_pad - c, 0, 0, 0, c_out_pad - c_out))
    return split_tf32(w.reshape(c_out_pad, kh * kw * c_pad))


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
    if x.dtype == torch.float32:
        return conv3x3_bn_act_f32(x, kernel, scale, bias, residual=residual, relu=relu)
    tensors = {"x": x, "kernel": kernel}
    if residual is not None:
        tensors["residual"] = residual
    for name, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"conv3x3 kernel: {name} must be a contiguous bfloat16 CUDA tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"conv3x3 kernel: {name} must be 16-byte aligned")
    check_conv3x3_shapes(x.shape, kernel.shape, None if residual is None else residual.shape)
    N, S, _, C = x.shape
    C_out = kernel.shape[-1]
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


def conv3x3_bn_act_f32(
    x: torch.Tensor,
    kernel: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    residual: Optional[torch.Tensor] = None,
    relu: bool = True,
) -> torch.Tensor:
    """``conv3x3_bn_act`` on f32 operands (``conv3x3_bn_act`` sends them here): the CPU
    takes ``conv3x3_bn_act_reference``, a CUDA tensor launches the f32 kernel of
    ``csrc/conv3x3_f32.cu`` (any C and C_out; the weights repacked by
    ``pack_conv3x3_f32`` on each call) or raises."""
    if x.device.type == "cpu":
        return conv3x3_bn_act_reference(x, kernel, scale, bias, residual, relu)
    tensors = {"x": x, "kernel": kernel}
    if residual is not None:
        tensors["residual"] = residual
    for name, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"conv3x3 f32 kernel: {name} must be a contiguous float32 CUDA tensor")
    check_conv3x3_f32_shapes(x.shape, kernel.shape, None if residual is None else residual.shape)
    N, S, _, C = x.shape
    C_out = kernel.shape[-1]
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.shape != (C_out,) or bias.shape != (C_out,):
        raise ValueError("conv3x3 f32 kernel: scale and bias must be (C_out,)")
    out = torch.empty((N, S, S, C_out), dtype=x.dtype, device=x.device)
    lib = _ext.library()
    with torch.cuda.device(x.device):
        w_hi, w_lo = pack_conv3x3_f32(kernel)
        status = lib.tpuhar_conv3x3_bn_act_f32_split(
            x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            N * S * S, S, C, C_out, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _ext.check(status, "tpuhar_conv3x3_bn_act_f32_split")
    conv3x3_bn_act_f32.launches += 1
    return out


conv3x3_bn_act_f32.launches = 0


def pack_conv3x3_i8(kernel_hwio: torch.Tensor) -> torch.Tensor:
    """``(3, 3, C, C_out)`` int8 HWIO kernel → the ``(C_out, 9·C)`` matrix the int8
    kernel reads: row ``n`` is output channel ``n``'s K run, in the order
    ``(dy·3 + dx)·C + c``."""
    kh, kw, c, c_out = kernel_hwio.shape
    return kernel_hwio.reshape(kh * kw * c, c_out).T.contiguous()


def quantize_activations(x: torch.Tensor, scale) -> torch.Tensor:
    """Per-tensor symmetric int8 quantization with a calibrated scale.

    A float ``scale`` becomes a 0-d f32 tensor on ``x``'s device: on CUDA, PyTorch
    divides by a host scalar as a multiply by its reciprocal, which rounds
    differently from the division the JAX package does."""
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def int8_conv(x_q, w_q, x_scale, w_scale, *, stride: int = 1, padding: Padding = "SAME"):
    """int8 NHWC conv, rescaled to f32: ``acc · (x_scale · w_scale)``; ``padding`` as
    ``conv_pads`` reads it.

    The accumulator is computed in float64, which holds every int8 × int8 sum of the
    tower exactly (|acc| ≤ 4608·127² < 2⁵³), and rounds to f32 as XLA's int32 → f32
    convert does. ``w_scale`` is per output channel."""
    acc = conv_nhwc(x_q.double(), w_q.double(), stride, padding)
    return acc.float() * (x_scale * w_scale.reshape(-1).float())


def conv3x3_i8_reference(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    stride: int = 1,
    padding: Padding = "SAME",
    residual: Optional[torch.Tensor] = None,
    res_scale: Optional[float] = None,
    relu: bool = True,
    out_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version: ``int8_conv`` (float64 accumulator, exact) with ``padding``, then
    the epilogue in f32 in the JAX package's order. The result is contiguous NHWC, as
    the kernel's is (cuDNN's float64 conv returns NCHW memory, whose NHWC view would
    send later reductions through another summation order)."""
    C_out, C = w_packed.shape[0], x.shape[-1]
    y = int8_conv(x, w_packed.T.reshape(3, 3, C, C_out), 1.0, scale, stride=stride, padding=padding) + bias.float()
    if residual is not None:
        y = y + residual.float() * res_scale
    if relu:
        y = torch.relu(y)
    return (y if out_scale is None else quantize_activations(y, out_scale)).contiguous()


def check_conv3x3_i8_shapes(x_shape, w_shape, stride: int = 1, residual_shape=None) -> None:
    """Raise ``ValueError`` on shapes the int8 kernel does not take: ``x`` is
    ``(N, S, S, C)`` and the weights ``(C_out, 9·C)`` (``pack_conv3x3_i8``), with ``C``
    and ``C_out`` multiples of 32 (a partial 128-byte row of channels is zero-filled in
    the kernel), stride 1 or 2, the residual ``(N, S', S', C_out)`` with ``S' =
    ⌈S / stride⌉``, and ``x`` indexable with 32-bit offsets."""
    if len(x_shape) != 4:
        raise ValueError(f"conv3x3_i8 kernel: x must be (N, S, S, C), got {tuple(x_shape)}")
    N, S, S2, C = x_shape
    if S != S2:
        raise ValueError(f"conv3x3_i8 kernel: square planes only, got {(S, S2)}")
    if len(w_shape) != 2 or w_shape[1] != 9 * C:
        raise ValueError(f"conv3x3_i8 kernel: weights {tuple(w_shape)} != (C_out, {9 * C})")
    C_out = w_shape[0]
    if C % 32 or C_out % 32 or min(C, C_out) <= 0:
        raise ValueError(f"conv3x3_i8 kernel: C={C} and C_out={C_out} must be multiples of 32")
    if stride not in (1, 2):
        raise ValueError(f"conv3x3_i8 kernel: stride {stride} is not 1 or 2")
    So = -(-S // stride)
    if residual_shape is not None and tuple(residual_shape) != (N, So, So, C_out):
        raise ValueError(f"conv3x3_i8 kernel: residual {tuple(residual_shape)} != {(N, So, So, C_out)}")
    if N * S * S * C >= 2**31:
        raise ValueError(f"conv3x3_i8 kernel: x of {N * S * S * C} elements exceeds 2^31")


def conv3x3_i8_pad_lo(size: int, stride: int, padding: Padding = "SAME") -> int:
    """The low pad the int8 kernel takes for ``padding`` (``"SAME"`` or one ``(lo, hi)``
    pair per spatial axis, as ``conv_pads`` reads it) on a square ``size`` plane.

    The kernel pads both axes alike and writes ``⌈size / stride⌉`` outputs a side, so
    it takes a padding only when the two axes' pairs are equal and ``(size + lo + hi −
    3) // stride + 1`` is that side: SAME, and ``(1, 1)`` at stride 1 and at stride 2.
    Raises ``ValueError`` on any other."""
    pads = conv_pads((size, size), (3, 3), stride, padding)
    if pads[0] != pads[1] or min(pads[0]) < 0:
        raise ValueError(f"conv3x3_i8 kernel: padding {padding!r} must pad both axes alike, got {pads}")
    lo, hi = pads[0]
    side, so = (size + lo + hi - 3) // stride + 1, -(-size // stride)
    if side != so:
        raise ValueError(
            f"conv3x3_i8 kernel: padding {padding!r} at stride {stride} on {size}² gives a side of {side}, "
            f"the kernel writes ⌈{size}/{stride}⌉ = {so}"
        )
    return lo


def conv3x3_i8(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    stride: int = 1,
    padding: Padding = "SAME",
    residual: Optional[torch.Tensor] = None,
    res_scale: Optional[float] = None,
    relu: bool = True,
    out_scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused int8 3×3 conv: ``act(acc · scale + bias [+ residual · res_scale])``,
    requantized to int8 with ``out_scale`` or stored f32.

    Args:
      x: ``(N, S, S, C)`` int8 NHWC activations.
      w_packed: ``(C_out, 9·C)`` int8 (``pack_conv3x3_i8`` of the HWIO kernel).
      scale: ``(C_out,)`` f32, the input's scale times the weights' (``x_scale·w_scale``).
      bias: ``(C_out,)`` f32.
      stride: 1 or 2.
      padding: ``"SAME"`` (XLA's split: stride 2 on an even plane pads 0 before and 1
        after) or ``(lo, hi)`` pairs, such as ResNet-18's ``[(1, 1), (1, 1)]``; the
        kernel takes those whose output side is ``⌈S / stride⌉``
        (``conv3x3_i8_pad_lo``).
      residual: optional ``(N, S', S', C_out)`` int8, added as ``residual · res_scale``.
      relu: apply ReLU after the residual.
      out_scale: requantize with ``clip(round(y / out_scale), −127, 127)``; ``None``
        returns f32.
    """
    if x.device.type == "cpu":
        return conv3x3_i8_reference(
            x, w_packed, scale, bias, stride=stride, padding=padding, residual=residual,
            res_scale=res_scale, relu=relu, out_scale=out_scale,
        )
    tensors = {"x": x, "w_packed": w_packed}
    if residual is not None:
        tensors["residual"] = residual
    for name, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError(f"conv3x3_i8 kernel: {name} must be a contiguous int8 CUDA tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"conv3x3_i8 kernel: {name} must be 16-byte aligned")
    check_conv3x3_i8_shapes(x.shape, w_packed.shape, stride, None if residual is None else residual.shape)
    pad_lo = conv3x3_i8_pad_lo(x.shape[1], stride, padding)
    if residual is not None and res_scale is None:
        raise ValueError("conv3x3_i8 kernel: a residual needs its res_scale")
    if out_scale is not None and not out_scale > 0:
        raise ValueError(f"conv3x3_i8 kernel: out_scale must be positive, got {out_scale}")
    N, S, _, C = x.shape
    C_out = w_packed.shape[0]
    So = -(-S // stride)
    M = N * So * So
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.shape != (C_out,) or bias.shape != (C_out,):
        raise ValueError("conv3x3_i8 kernel: scale and bias must be (C_out,)")
    out_dtype = torch.float32 if out_scale is None else torch.int8
    out = torch.empty((N, So, So, C_out), dtype=out_dtype, device=x.device)
    lib = _ext.library()
    with torch.cuda.device(x.device):
        status = lib.tpuhar_conv3x3_i8(
            x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            M, S, So, C, C_out, stride, pad_lo, int(relu),
            0.0 if residual is None else float(res_scale),
            int(out_scale is not None), 1.0 if out_scale is None else float(out_scale),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _ext.check(status, "tpuhar_conv3x3_i8")
    conv3x3_i8.launches += 1
    return out


conv3x3_i8.launches = 0
