"""Non-causal flash attention for the ViT's token stream (``tpuhar/ops/flash_lean.py``,
and the stock Pallas TPU kernel behind ``tpuhar/ops/attention.py: flash_mha``), forward
and backward.

``flash_lean(q, k, v)`` computes ``softmax(q kᵀ · sm_scale) v`` over ``(B, H, N, D)``
tensors as the TPU kernel does: f32 scores and softmax, the probabilities rounded to
v's type for the product with v, an f32 sum, then the division by the normalizer. A
tensor on the CPU takes the plain path (``flash_lean_reference``); a CUDA tensor
launches the kernel of ``csrc/flash_attn.cu`` or raises. The kernel takes bf16 with
D = 64 (the head width of every ``VIT_CONFIGS`` entry) and any strides whose last is 1,
so views of the ``(B, N, H·D)`` projections go in as they are. ``flash_lean.launches``
counts its launches.

``FlashLean`` gives the forward a gradient: it saves each row's log-sum-exp and the
output in f32 (``flash_lean_with_stats``, the same kernel with two more outputs), and its
backward runs the dQ and the dK/dV kernels of ``csrc/flash_attn_bwd.cu``, the ports of
the stock TPU kernel's two backward kernels (``flash_lean_bwd_dq``,
``flash_lean_bwd_dkv``, each with its ``launches``), or autograd through the plain
version on the CPU.

The TPU kernel's ``block_q``/``block_k`` are tiles of the TPU's memory and change no
result (at its defaults ``(392, 1792)`` it clamps the KV block to N and runs one
full-KV tile per query tile). The Hopper kernel has its own fixed tiles (192 query
rows, 112 key rows), so this function takes no block sizes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _ext

HEAD_DIM = 64  # the one head width the kernel takes
QUERY_TILE = 192  # query rows of one work item of the kernel's persistent grid


def _reference_f32(q, k, v, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version's output before its rounding to q's type, and each row's
    log-sum-exp of the scaled scores, both f32."""
    s = (q.float() @ k.float().mT) * sm_scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return (p.to(v.dtype).float() @ v.float()) / l, (m + torch.log(l)).squeeze(-1)


def flash_lean_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: Optional[float] = None
) -> torch.Tensor:
    """Plain version: the TPU kernel's one-tile math, step by step; the ``(N, N)``
    score matrix is materialized in f32."""
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    return _reference_f32(q, k, v, sm_scale)[0].to(q.dtype)


def check_flash_operand(name: str, shape, strides, data_ptr: int, expected_shape, itemsize: int = 2) -> None:
    """Raise ``ValueError`` on a q, k or v the kernel does not take, from its shape, its
    element strides and its address alone: ``(B, H, N, 64)``, unit stride on the head
    width, a 16-byte aligned base and batch, head and token strides that are multiples
    of 16 bytes (8 bf16 elements, or 4 of ``itemsize`` 4), so that every row starts on a
    16-byte boundary, and positive wherever the dimension has more than one element (the
    kernel reads through a tensor map, which takes no broadcast dimension)."""
    if tuple(shape) != tuple(expected_shape):
        raise ValueError(f"flash_lean kernel: {name} {tuple(shape)} != {tuple(expected_shape)}")
    if shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_lean kernel: head_dim {shape[-1]} is not {HEAD_DIM}")
    step = 16 // itemsize
    if strides[-1] != 1 or data_ptr % 16 or any(s % step for s in strides[:3]):
        raise ValueError(
            f"flash_lean kernel: {name} needs unit stride on D, 16-byte aligned rows "
            f"and strides that are multiples of {step}, got strides {tuple(strides)}"
        )
    if any(s <= 0 for s, n in zip(strides[:3], shape[:3]) if n > 1):
        raise ValueError(f"flash_lean kernel: {name} has a broadcast or reversed dimension, strides {tuple(strides)}")


def check_flash_scale(sm_scale: float) -> None:
    """Raise ``ValueError`` unless ``sm_scale`` is positive: the kernel keeps the running
    max of the raw scores and scales afterwards, which is the max of the scaled scores
    only for a positive scale. The plain version takes any scale."""
    if not sm_scale > 0:
        raise ValueError(f"flash_lean kernel: sm_scale must be positive, got {sm_scale}")


def _forward_kernel(q, k, v, sm_scale: float, stats: bool):
    """One launch of the forward kernel → ``(out, lse, out_f32)``. With ``stats`` it also
    stores each row's log-sum-exp, ``(B, H, N)`` f32, and the output in f32 before its
    rounding, a view of a ``(B, N, H, D)`` buffer like ``out``; without, those two are
    None and the kernel stores nothing more."""
    B, H, N, D = q.shape
    check_flash_scale(sm_scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_lean kernel: {name} must be a bfloat16 tensor on {q.device}")
        check_flash_operand(name, t.shape, t.stride(), t.data_ptr(), (B, H, N, D))
    if B * H * -(-N // QUERY_TILE) >= 2**31:
        raise ValueError(f"flash_lean kernel: B·H·⌈N/{QUERY_TILE}⌉ work items exceed 2^31")
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = out_f32 = None
    if stats:
        lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
        out_f32 = torch.empty((B, N, H, D), dtype=torch.float32, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out, lse, out_f32
    lib = _ext.library()
    with torch.cuda.device(q.device):
        status = lib.tpuhar_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if stats else 0, out_f32.data_ptr() if stats else 0,
            B, H, N, float(sm_scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _ext.check(status, "tpuhar_flash_attn")
    flash_lean.launches += 1
    return out, lse, out_f32


def flash_lean(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Non-causal attention over ``(B, H, N, D)`` tensors → ``(B, H, N, D)``.

    On a CUDA device the result is a view of a ``(B, N, H, D)`` buffer, so
    ``out.transpose(1, 2).reshape(B, N, H·D)`` is free, and ``sm_scale`` must be positive
    (``check_flash_scale``); the CPU's plain path takes any scale. ``launches`` counts the
    forward kernel's launches, those of ``flash_lean_with_stats`` included.
    """
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cpu":
        return flash_lean_reference(q, k, v, sm_scale)
    return _forward_kernel(q, k, v, sm_scale, stats=False)[0]


flash_lean.launches = 0


def flash_lean_with_stats(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_lean`` that also returns what the backward kernels read: each row's
    log-sum-exp of the scaled scores, ``(B, H, N)`` f32, which they recompute P from, and
    the output in f32 before its rounding, which the dQ kernel forms ``di`` from. On a
    CUDA device it is the same kernel with its two more pointers set."""
    if q.device.type == "cpu":
        out_f32, lse = _reference_f32(q, k, v, sm_scale)
        return out_f32.to(q.dtype), lse, out_f32
    return _forward_kernel(q, k, v, sm_scale, stats=True)


# ---------------------------------------------------------------------------------------
# Backward: the stock Pallas TPU kernel's dK/dV and dQ kernels
# (jax/experimental/pallas/ops/tpu/flash_attention.py: _flash_attention_bwd_dkv,
# _flash_attention_bwd_dq), ported as the two kernels of csrc/flash_attn_bwd.cu.
# ---------------------------------------------------------------------------------------
def flash_lean_backward_reference(q, k, v, dout, sm_scale: Optional[float] = None):
    """Plain version of the backward: ``(dq, dk, dv)`` by autograd through
    ``flash_lean_reference`` in the operands' type."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_lean_reference(*leaves, sm_scale)
        return torch.autograd.grad(out, leaves, dout)


def check_flash_grad_operands(B: int, H: int, N: int, stats) -> None:
    """Raise ``ValueError`` on saved statistics the backward kernels do not take, from
    shapes and contiguity alone: ``stats`` maps a name (``lse``, ``di``) to ``(shape,
    contiguous)``, each a contiguous ``(B, H, N)`` f32 tensor. The grids of both kernels,
    ``⌈N/128⌉ × H × B`` blocks (128 query rows a block for dQ, 128 key rows for dK/dV),
    need ``H`` and ``B`` from 1 to 65535 (CUDA's limit on a grid's second and third
    dimensions) and ``N ≥ 1``. ``q``, ``k``, ``v``, the output and ``dO`` are held to
    ``check_flash_operand``: both kernels read q, k, v and dO through tensor maps, and
    the dQ kernel the f32 output in 8-byte pieces."""
    for name, (shape, contiguous) in stats.items():
        if tuple(shape) != (B, H, N):
            raise ValueError(f"flash backward kernel: {name} {tuple(shape)} != {(B, H, N)}")
        if not contiguous:
            raise ValueError(f"flash backward kernel: {name} must be contiguous")
    if not (0 < B <= 65535 and 0 < H <= 65535 and N > 0):
        raise ValueError(f"flash backward kernel: grid of {B} batches x {H} heads x {N} tokens out of range")


def _grad_buffer(q: torch.Tensor) -> torch.Tensor:
    """A ``(B, H, N, 64)`` view of a ``(B, N, H, 64)`` bf16 buffer: the layout of the
    projections, so a gradient leaves the kernel as ``(B, N, H·64)`` without a copy."""
    B, H, N, D = q.shape
    return torch.empty((B, N, H, D), dtype=torch.bfloat16, device=q.device).transpose(1, 2)


def _check_backward(operands, stats, out_f32=None) -> None:
    """``operands``: name → a ``(B, H, N, 64)`` bf16 tensor the kernel reads (q first);
    ``stats``: name → a ``(B, H, N)`` f32 tensor it reads; ``out_f32`` the forward's f32
    output, if it reads it."""
    q = next(iter(operands.values()))
    B, H, N, D = q.shape
    for name, t in operands.items():
        if not t.is_cuda or t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"flash backward kernel: {name} must be a bfloat16 tensor on {q.device}")
        check_flash_operand(name, t.shape, t.stride(), t.data_ptr(), (B, H, N, D))
    if out_f32 is not None:
        if out_f32.device != q.device or out_f32.dtype != torch.float32:
            raise ValueError(f"flash backward kernel: out_f32 must be a float32 tensor on {q.device}")
        check_flash_operand("out_f32", out_f32.shape, out_f32.stride(), out_f32.data_ptr(), (B, H, N, D), itemsize=4)
    for name, t in stats.items():
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"flash backward kernel: {name} must be a float32 tensor on {q.device}")
    check_flash_grad_operands(B, H, N, {name: (t.shape, t.is_contiguous()) for name, t in stats.items()})


def flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dq, di)`` by the dQ kernel from the forward's f32 output and ``lse``
    (``flash_lean_with_stats``): ``di = rowsum(O∘dO)`` in f32, ``(B, H, N)``, which the
    dK/dV kernel reads; CUDA tensors only. ``launches`` counts its launches."""
    check_flash_scale(sm_scale)
    _check_backward({"q": q, "k": k, "v": v, "dO": dout}, {"lse": lse}, out_f32)
    B, H, N, _ = q.shape
    dq = _grad_buffer(q)
    di = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = _ext.library().tpuhar_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out_f32.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B, H, N, float(sm_scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out_f32.stride()[:3],
            *dout.stride()[:3], *dq.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _ext.check(status, "tpuhar_flash_bwd_dq")
    flash_lean_bwd_dq.launches += 1
    return dq, di


flash_lean_bwd_dq.launches = 0


def flash_lean_bwd_dkv(q, k, v, dout, lse, di, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` by the dK/dV kernel from the forward's ``lse`` and the dQ kernel's
    ``di``; CUDA tensors only. ``launches`` counts its launches."""
    check_flash_scale(sm_scale)
    _check_backward({"q": q, "k": k, "v": v, "dO": dout}, {"lse": lse, "di": di})
    B, H, N, _ = q.shape
    dk, dv = _grad_buffer(q), _grad_buffer(q)
    with torch.cuda.device(q.device):
        status = _ext.library().tpuhar_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, N, float(sm_scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _ext.check(status, "tpuhar_flash_bwd_dkv")
    flash_lean_bwd_dkv.launches += 1
    return dk, dv


flash_lean_bwd_dkv.launches = 0


def flash_lean_backward(q, k, v, out_f32, dout, lse, sm_scale: float):
    """``(dq, dk, dv)`` of ``flash_lean`` for the output gradient ``dout``, from the
    forward's f32 output and log-sum-exp (``flash_lean_with_stats``). A CPU tensor takes
    ``flash_lean_backward_reference``; on a CUDA device the dQ kernel runs first (and
    leaves ``di = rowsum(O∘dO)``), then the dK/dV kernel; the gradients are views of
    ``(B, N, H, 64)`` buffers."""
    if q.device.type == "cpu":
        return flash_lean_backward_reference(q, k, v, dout, sm_scale)
    dq, di = flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, sm_scale)
    return (dq, *flash_lean_bwd_dkv(q, k, v, dout, lse, di, sm_scale))


class FlashLean(torch.autograd.Function):
    """``flash_lean`` with a gradient: the forward keeps q, k, v, the f32 output and the
    log-sum-exp; the backward is ``flash_lean_backward`` (the two kernels on a CUDA
    device, autograd through the plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float):
        out, lse, out_f32 = flash_lean_with_stats(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, out_f32, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out_f32, lse = ctx.saved_tensors
        if dout.is_cuda:
            try:
                check_flash_operand("dO", dout.shape, dout.stride(), dout.data_ptr(), q.shape)
            except ValueError:  # a broadcast or packed gradient: the kernels read 16-byte rows
                dout = dout.contiguous()
        dq, dk, dv = flash_lean_backward(q, k, v, out_f32, dout, lse, ctx.sm_scale)
        return dq, dk, dv, None
