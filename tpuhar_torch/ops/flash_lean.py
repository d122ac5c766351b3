"""Forward-only, non-causal flash attention for the ViT's token stream
(``tpuhar/ops/flash_lean.py``).

``flash_lean(q, k, v)`` computes ``softmax(q kᵀ · sm_scale) v`` over ``(B, H, N, D)``
tensors as the TPU kernel does: f32 scores and softmax, the probabilities rounded to
v's type for the product with v, an f32 sum, then the division by the normalizer. A
tensor on the CPU takes the plain path (``flash_lean_reference``); a CUDA tensor
launches the kernel of ``csrc/flash_attn.cu`` or raises. The kernel takes bf16 with
D = 64 (the head width of every ``VIT_CONFIGS`` entry) and any strides whose last is 1,
so views of the ``(B, N, H·D)`` projections go in as they are. ``flash_lean.launches``
counts its launches.

The TPU kernel's ``block_q``/``block_k`` are tiles of the TPU's memory and change no
result (at its defaults ``(392, 1792)`` it clamps the KV block to N and runs one
full-KV tile per query tile). The Hopper kernel has its own fixed tiles (192 query
rows, 112 key rows), so this function takes no block sizes.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _ext

HEAD_DIM = 64  # the one head width the kernel takes
QUERY_TILE = 192  # query rows of one work item of the kernel's persistent grid


def flash_lean_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: Optional[float] = None
) -> torch.Tensor:
    """Plain version: the TPU kernel's one-tile math, step by step; the ``(N, N)``
    score matrix is materialized in f32."""
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    s = (q.float() @ k.float().mT) * sm_scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    return ((p.to(v.dtype).float() @ v.float()) / l).to(q.dtype)


def check_flash_operand(name: str, shape, strides, data_ptr: int, expected_shape) -> None:
    """Raise ``ValueError`` on a q, k or v the kernel does not take, from its shape, its
    element strides and its address alone: ``(B, H, N, 64)``, unit stride on the head
    width, a 16-byte aligned base and batch, head and token strides that are multiples
    of 8 elements, so that every 128-byte row starts on a 16-byte boundary, and positive
    wherever the dimension has more than one element (the kernel reads through a tensor
    map, which takes no broadcast dimension)."""
    if tuple(shape) != tuple(expected_shape):
        raise ValueError(f"flash_lean kernel: {name} {tuple(shape)} != {tuple(expected_shape)}")
    if shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_lean kernel: head_dim {shape[-1]} is not {HEAD_DIM}")
    if strides[-1] != 1 or data_ptr % 16 or any(s % 8 for s in strides[:3]):
        raise ValueError(
            f"flash_lean kernel: {name} needs unit stride on D, 16-byte aligned rows "
            f"and strides that are multiples of 8, got strides {tuple(strides)}"
        )
    if any(s <= 0 for s, n in zip(strides[:3], shape[:3]) if n > 1):
        raise ValueError(f"flash_lean kernel: {name} has a broadcast or reversed dimension, strides {tuple(strides)}")


def check_flash_scale(sm_scale: float) -> None:
    """Raise ``ValueError`` unless ``sm_scale`` is positive: the kernel keeps the running
    max of the raw scores and scales afterwards, which is the max of the scaled scores
    only for a positive scale. The plain version takes any scale."""
    if not sm_scale > 0:
        raise ValueError(f"flash_lean kernel: sm_scale must be positive, got {sm_scale}")


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
    (``check_flash_scale``); the CPU's plain path takes any scale.
    """
    B, H, N, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / D**0.5
    if q.device.type == "cpu":
        return flash_lean_reference(q, k, v, sm_scale)
    check_flash_scale(sm_scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_lean kernel: {name} must be a bfloat16 tensor on {q.device}")
        check_flash_operand(name, t.shape, t.stride(), t.data_ptr(), (B, H, N, D))
    if B * H * -(-N // QUERY_TILE) >= 2**31:
        raise ValueError(f"flash_lean kernel: B·H·⌈N/{QUERY_TILE}⌉ work items exceed 2^31")
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    lib = _ext.library()
    with torch.cuda.device(q.device):
        status = lib.tpuhar_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N, float(sm_scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _ext.check(status, "tpuhar_flash_attn")
    flash_lean.launches += 1
    return out


flash_lean.launches = 0
