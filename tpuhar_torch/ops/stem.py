"""Patch-major clip layout and the uint8 stem GEMM (``tpuhar/ops/stem.py``).

The host ships each clip patch-major, ``(..., H/p, W/p, p²·3)``, so that the
``tpu_cnn`` stem is one K=768 GEMM against the packed ``(p²·3, C0)`` kernel.

``stem_gemm_u8`` is the int8 serving stem on that wire: the byte map
``max(u8, 1) ^ 0x80`` gives the int8 codes ``clip(u8 − 128, −127, 127)`` (the JAX
package's ``sub=128, clip_lo=-127``, the only map its int8 path uses), then the int8
GEMM against the K-major ``(C0, K)`` weights (``pack_stem_u8``: int8 ``wgmma`` reads
its B operand K-major only), ``acc · scale + bias``, ReLU and an optional requant to
int8. A CPU tensor takes the plain path (``stem_gemm_u8_reference``); a CUDA tensor
launches the kernel of ``csrc/stem_u8.cu``, the port of ``stem_gemm_u8_pallas`` and of
its XLA twin ``stem_gemm_u8``, or raises. ``stem_gemm_u8.launches`` counts the kernel's
launches.

The centered int8 wire ships the same codes made on the host, in the numpy pass of the
patch shuffle (``to_patch_major(..., centered=True)``, ``center_u8``): int8 pixels go
into the GEMM as they are, through the kernel's signed form (``int8_gemm``).

``int8_gemm`` is the same kernel without the byte map, on int8 codes: the fused
``epilogue(x_q @ w_packed.T)`` that stands for the XLA int8 products of the JAX
package's int8 towers (``int8_dense``: the ViT's dense layers; ResNet-18's 7×7 stem on
its im2col rows and its 1×1 downsample convs). ``int8_gemm_reference`` is its plain
version; ``int8_gemm.launches`` counts its launches.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import _ext


def pack_stem_weights(kernel_hwio):
    """``(p, p, C_in, C0)`` HWIO kernel → ``(p²·C_in, C0)`` GEMM matrix, rows in the
    order ``((row · p) + col) · C_in + ch`` that ``to_patch_major`` produces."""
    p, p2, cin, c0 = kernel_hwio.shape
    if p != p2:
        raise ValueError(f"square patch kernels only, got {tuple(kernel_hwio.shape)}")
    return kernel_hwio.reshape(p * p * cin, c0)


def pack_stem_u8(kernel_hwio: torch.Tensor) -> torch.Tensor:
    """``(p, p, C_in, C0)`` int8 HWIO kernel → the ``(C0, p²·C_in)`` matrix the uint8
    stem kernel reads: the transpose of ``pack_stem_weights``, row ``n`` output channel
    ``n``'s K run."""
    return pack_stem_weights(kernel_hwio).T.contiguous()


def center_u8(col: np.ndarray) -> np.ndarray:
    """HOST-side int8 wire encoding: ``clip(u8 − 128, −127, 127)`` as int8, one XOR and
    one max on the same bytes (u8 0 → −127, as the byte map ``max(u8, 1) ^ 0x80``
    gives)."""
    return np.maximum(np.bitwise_xor(col.view(np.int8), np.int8(-128)), np.int8(-127))


def _patch_shape(shape, patch: int):
    *lead, H, W, C = shape
    Hp, Wp = H // patch, W // patch
    if Hp * patch != H or Wp * patch != W:
        raise ValueError(f"frames {tuple(shape)} do not tile into {patch}x{patch} patches")
    return lead, Hp, Wp, C


def to_patch_major(frames: np.ndarray, patch: int = 16, *, centered: bool = False) -> np.ndarray:
    """HOST-side layout shuffle: ``(..., H, W, C)`` uint8 → ``(..., H/p, W/p, p²·C)``.

    ``centered=True`` also ships the int8 wire encoding (``center_u8``) the quantized
    stem reads as it is."""
    lead, Hp, Wp, C = _patch_shape(frames.shape, patch)
    x = frames.reshape(*lead, Hp, patch, Wp, patch * C)
    x = np.moveaxis(x, -3, -2)  # (..., Hp, Wp, patch, patch·C)
    col = np.ascontiguousarray(x).reshape(*lead, Hp, Wp, patch * patch * C)
    return center_u8(col) if centered else col


def to_patch_major_tensor(frames: torch.Tensor, patch: int = 16) -> torch.Tensor:
    """The device-side ``to_patch_major`` of a tensor (one permuting copy on its
    device), for callers that hold the clip there already."""
    lead, Hp, Wp, C = _patch_shape(frames.shape, patch)
    x = frames.reshape(*lead, Hp, patch, Wp, patch * C).transpose(-3, -2)
    return x.reshape(*lead, Hp, Wp, patch * patch * C)


def is_patch_major(x, patch: int, cin: int = 3) -> bool:
    """Shape test: the trailing dim is ``p²·C_in`` (patch-major), not ``C_in`` (NHWC)."""
    return x.ndim >= 3 and x.shape[-1] == patch * patch * cin


def _check_wire(col: torch.Tensor) -> None:
    if col.dtype not in (torch.uint8, torch.int8):
        raise TypeError(
            f"stem_gemm_u8 takes uint8 patch-major pixels or their centered int8 codes, got {col.dtype}"
        )


def _epilogue(acc: torch.Tensor, scale, bias, relu: bool, out_scale: Optional[float]) -> torch.Tensor:
    """``acc·scale + bias`` in f32, ReLU, and with ``out_scale``
    ``clip(round(y / out_scale), −127, 127)`` as int8: the kernels' epilogue, plainly."""
    y = acc * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    if out_scale is None:
        return y
    s = torch.tensor(out_scale, dtype=torch.float32, device=y.device)
    return torch.clamp(torch.round(y / s), -127, 127).to(torch.int8)


def stem_gemm_u8_reference(
    col_u8: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    relu: bool = True,
    out_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version: the byte map in uint8 (int8 codes of the centered wire as they
    are), the GEMM against ``w_packed`` ``(C0, K)`` in float64 (exact: every 768-term
    int8 dot is below 2²⁴), then ``acc·scale + bias``, ReLU and, with ``out_scale``,
    ``clip(round(y / out_scale), −127, 127)`` as int8."""
    _check_wire(col_u8)
    if col_u8.dtype == torch.int8:
        x = col_u8
    else:
        x = torch.bitwise_xor(torch.clamp(col_u8, min=1), 0x80).view(torch.int8)
    return _epilogue((x.double() @ w_packed.double().T).float(), scale, bias, relu, out_scale)


def _check_gemm_shapes(kernel: str, col_shape, w_shape) -> None:
    if len(w_shape) != 2 or len(col_shape) < 1:
        raise ValueError(f"{kernel} kernel: rows (..., K) and weights (C0, K), got {tuple(col_shape)}, {tuple(w_shape)}")
    C0, K = w_shape
    if col_shape[-1] != K:
        if col_shape[-1] == C0:
            raise ValueError(
                f"{kernel} kernel: weights {tuple(w_shape)} look like (K, C0); K-major (C0, K) "
                "expected (ops/stem.pack_stem_u8)"
            )
        raise ValueError(f"{kernel} kernel: rows {tuple(col_shape)} do not match weights (C0, K) = {(C0, K)}")
    if K % 64 or C0 % 32 or min(K, C0) <= 0:
        raise ValueError(f"{kernel} kernel: K={K} must be a multiple of 64 and C0={C0} of 32")
    M = math.prod(col_shape[:-1])
    if M >= 2**31:
        raise ValueError(f"{kernel} kernel: {M} rows exceed 2^31")


def check_stem_u8_shapes(col_shape, w_shape) -> None:
    """Raise ``ValueError`` on shapes the uint8 stem kernel does not take: pixels
    ``(..., K)`` against K-major weights ``(C0, K)`` (``pack_stem_u8``), ``K`` a multiple
    of 64 and ``C0`` of 32."""
    _check_gemm_shapes("stem_u8", col_shape, w_shape)


def check_int8_gemm_shapes(x_shape, w_shape) -> None:
    """Raise ``ValueError`` on shapes the int8 GEMM kernel does not take: the stem's
    (``check_stem_u8_shapes``), on int8 codes ``(..., K)``. A K that is not a multiple
    of 64 (ResNet-18's 7·7·3 = 147) is padded with zero columns by the caller, in the
    codes and in the packed weights alike."""
    _check_gemm_shapes("int8_gemm", x_shape, w_shape)


def stem_gemm_u8(
    col_u8: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    relu: bool = True,
    out_scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused ``epilogue(clip(col_u8 − 128, −127, 127) @ w_packed)``.

    Branches on the wire's dtype, as the JAX package's ``stem_gemm_u8`` does: uint8
    pixels take the byte map in the stem kernel (counted on ``stem_gemm_u8.launches``);
    int8 codes of the centered wire (``to_patch_major(..., centered=True)``) go into the
    GEMM as they are, through ``int8_gemm`` with the same epilogue (counted on
    ``int8_gemm.launches``).

    Args:
      col_u8: ``(..., K)`` uint8 patch-major pixels (``to_patch_major``), or their
        centered int8 codes.
      w_packed: ``(C0, K)`` int8 (``pack_stem_u8`` of the quantized kernel).
      scale, bias: ``(C0,)`` f32, applied as ``acc · scale + bias``.
      relu: apply ReLU.
      out_scale: requantize to int8 with this scale; ``None`` returns f32.
    Returns ``(..., C0)``, int8 with ``out_scale``, else f32.
    """
    if col_u8.device.type == "cpu":
        return stem_gemm_u8_reference(
            col_u8, w_packed, scale, bias, relu=relu, out_scale=out_scale
        )
    _check_wire(col_u8)
    if col_u8.dtype == torch.int8:
        return int8_gemm(col_u8, w_packed, scale, bias, relu=relu, out_scale=out_scale)
    for name, t, dtype in (("col_u8", col_u8, torch.uint8), ("w_packed", w_packed, torch.int8)):
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"stem_u8 kernel: {name} must be a contiguous {dtype} CUDA tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"stem_u8 kernel: {name} must be 16-byte aligned")
    check_stem_u8_shapes(col_u8.shape, w_packed.shape)
    C0, K = w_packed.shape
    M = col_u8.numel() // K
    if out_scale is not None and not out_scale > 0:
        raise ValueError(f"stem_u8 kernel: out_scale must be positive, got {out_scale}")
    scale = scale.to(device=col_u8.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=col_u8.device, dtype=torch.float32).contiguous()
    if scale.shape != (C0,) or bias.shape != (C0,):
        raise ValueError("stem_u8 kernel: scale and bias must be (C0,)")
    out_dtype = torch.float32 if out_scale is None else torch.int8
    out = torch.empty((*col_u8.shape[:-1], C0), dtype=out_dtype, device=col_u8.device)
    lib = _ext.library()
    with torch.cuda.device(col_u8.device):
        status = lib.tpuhar_stem_u8(
            col_u8.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), M, K, C0, int(relu),
            int(out_scale is not None), 1.0 if out_scale is None else float(out_scale),
            torch.cuda.current_stream(col_u8.device).cuda_stream,
        )
    _ext.check(status, "tpuhar_stem_u8")
    stem_gemm_u8.launches += 1
    return out


stem_gemm_u8.launches = 0


def int8_gemm_reference(
    x_q: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    relu: bool = False,
    out_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version: the int8 product against ``w_packed`` ``(C0, K)`` in float64, exact
    for every K the towers have (|acc| ≤ 3072·127² < 2⁵³), rounded to f32 as XLA's
    int32 → f32 convert rounds, then ``acc·scale + bias``, ReLU and the optional requant
    in f32, in the JAX package's order."""
    if x_q.dtype != torch.int8:
        raise TypeError(f"int8_gemm takes int8 codes, got {x_q.dtype}")
    acc = (x_q.double() @ w_packed.double().T).float()
    return _epilogue(acc, scale, bias, relu, out_scale)


def int8_gemm(
    x_q: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    relu: bool = False,
    out_scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused ``epilogue(x_q @ w_packed.T)`` on int8 codes.

    Args:
      x_q: ``(..., K)`` int8 codes.
      w_packed: ``(C0, K)`` int8, K-major.
      scale, bias: ``(C0,)`` f32, applied as ``acc · scale + bias`` (``scale`` is the
        codes' scale times the weights', ``x_scale · w_scale``).
      relu: apply ReLU.
      out_scale: requantize to int8 with this scale; ``None`` returns f32.
    Returns ``(..., C0)``, int8 with ``out_scale``, else f32.
    """
    if x_q.device.type == "cpu":
        return int8_gemm_reference(x_q, w_packed, scale, bias, relu=relu, out_scale=out_scale)
    for name, t in (("x_q", x_q), ("w_packed", w_packed)):
        if not t.is_cuda or t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError(f"int8_gemm kernel: {name} must be a contiguous int8 CUDA tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"int8_gemm kernel: {name} must be 16-byte aligned")
    check_int8_gemm_shapes(x_q.shape, w_packed.shape)
    C0, K = w_packed.shape
    M = x_q.numel() // K
    if out_scale is not None and not out_scale > 0:
        raise ValueError(f"int8_gemm kernel: out_scale must be positive, got {out_scale}")
    scale = scale.to(device=x_q.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x_q.device, dtype=torch.float32).contiguous()
    if scale.shape != (C0,) or bias.shape != (C0,):
        raise ValueError("int8_gemm kernel: scale and bias must be (C0,)")
    out = torch.empty((*x_q.shape[:-1], C0), dtype=torch.float32 if out_scale is None else torch.int8,
                      device=x_q.device)
    lib = _ext.library()
    with torch.cuda.device(x_q.device):
        status = lib.tpuhar_int8_gemm(
            x_q.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), M, K, C0, int(relu),
            int(out_scale is not None), 1.0 if out_scale is None else float(out_scale),
            torch.cuda.current_stream(x_q.device).cuda_stream,
        )
    _ext.check(status, "tpuhar_int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def verify_byte_map(device) -> None:
    """Preflight: every uint8 value through ``stem_gemm_u8``'s byte map and an
    identity-weight GEMM (K = C0 = 256) on ``device``, against ``clip(u8 − 128, −127,
    127)``.

    Raises ``RuntimeError`` on any mismatch. The JAX package's int8-space map once
    miscompiled on its backend for half the byte range; this proves the route that
    serves, on the device that serves it.
    """
    col = torch.arange(256, dtype=torch.uint8, device=device).reshape(1, 256)
    w = torch.eye(256, dtype=torch.int8, device=device)
    ones = torch.ones(256, dtype=torch.float32, device=device)
    zeros = torch.zeros(256, dtype=torch.float32, device=device)
    got = stem_gemm_u8(col, w, ones, zeros, relu=False)
    got = got.reshape(256).cpu().numpy().astype(np.int64)
    ref = np.clip(np.arange(256) - 128, -127, 127)
    bad = np.flatnonzero(got != ref)
    if bad.size:
        raise RuntimeError(
            f"int8 stem byte map is WRONG on {device}: {bad.size}/256 byte values "
            f"(first: u8={bad[0]} -> {got[bad[0]]}, want {ref[bad[0]]}); the int8 "
            "serving path would give garbage logits"
        )
