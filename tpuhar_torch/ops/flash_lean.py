"""Non-causal flash attention for the ViT's token stream (``tpuhar/ops/flash_lean.py``,
and the stock Pallas TPU kernel behind ``tpuhar/ops/attention.py: flash_mha``), forward
and backward.

``flash_lean(q, k, v)`` computes ``softmax(q kᵀ · sm_scale) v`` over ``(B, H, N, D)``
tensors as the TPU kernel does: f32 scores and softmax, the probabilities rounded to
v's type for the product with v, an f32 sum, then the division by the normalizer. A
tensor on the CPU takes the plain path (``flash_lean_reference``); a CUDA tensor
launches a kernel or raises. The kernels take D = 64 (the head width of every
``VIT_CONFIGS`` entry) and any strides whose last is 1, so views of the ``(B, N, H·D)``
projections go in as they are, in one of two types, as the TPU kernels run in the
input's: bf16 goes to ``csrc/flash_attn.cu`` (``flash_lean.launches`` counts its
launches), f32 to ``csrc/flash_attn_f32.cu`` (full f32 on the tensor cores in split TF32,
three TF32 products an f32 one, whatever the matmul precision;
``flash_lean_f32.launches``); any other type raises.

``FlashLean`` gives the forward a gradient: it saves each row's log-sum-exp and the
output in f32 (``flash_lean_with_stats``, the same kernel with more outputs), and its
backward runs the dQ and the dK/dV kernels, the ports of the stock TPU kernel's two
backward kernels: ``csrc/flash_attn_bwd.cu`` for bf16 (``flash_lean_bwd_dq``,
``flash_lean_bwd_dkv``, each with its ``launches``), ``csrc/flash_attn_bwd_f32.cu`` for
f32 (``flash_lean_bwd_dq_f32``, ``flash_lean_bwd_dkv_f32``: full f32 on the tensor cores
in split TF32, as the f32 forward, whatever the matmul precision); or autograd through
the plain version on the CPU. The gradients come back in q's type.

The TPU kernel's ``block_q``/``block_k`` are tiles of the TPU's memory and change no
result (at its defaults ``(392, 1792)`` it clamps the KV block to N and runs one
full-KV tile per query tile). The Hopper kernels have their own fixed tiles (bf16: 192
query rows, 112 key rows; f32: 128 and 64), so this function takes no block sizes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _ext

HEAD_DIM = 64  # the one head width the kernels take
# operand type → query rows of one work item of its forward kernel (bf16: the persistent
# grid's items; f32: one block each)
QUERY_TILE = {torch.bfloat16: 192, torch.float32: 128}


def _reference_sums(q, k, v, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version's output before its rounding to q's type, and each row's
    log-sum-exp of the scaled scores: in f32, or in float64 for float64 operands (the
    exact reference the f32 kernels are held to)."""
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = (q.to(wide) @ k.to(wide).mT) * sm_scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return (p.to(v.dtype).to(wide) @ v.to(wide)) / l, (m + torch.log(l)).squeeze(-1)


def flash_lean_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: Optional[float] = None
) -> torch.Tensor:
    """Plain version: the TPU kernel's one-tile math, step by step; the ``(N, N)``
    score matrix is materialized in f32 (in float64 for float64 operands)."""
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    return _reference_sums(q, k, v, sm_scale)[0].to(q.dtype)


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


# operand type → bytes of one element: the types the kernels take
FLASH_DTYPES = {torch.bfloat16: 2, torch.float32: 4}


def check_flash_dtypes(what: str, operands) -> torch.dtype:
    """Raise ``ValueError`` unless the tensors of ``operands`` (name → tensor, q first)
    share one type the kernels take (bf16 or f32) and q's device, and each passes
    ``check_flash_operand`` at that type's element size; return the type. The device
    itself is the wrapper's to check."""
    q = next(iter(operands.values()))
    if q.dtype not in FLASH_DTYPES:
        raise ValueError(f"{what}: q must be a bfloat16 or float32 tensor, got {q.dtype}")
    for name, t in operands.items():
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} must be a {q.dtype} tensor on {q.device}, as q is")
        check_flash_operand(name, t.shape, t.stride(), t.data_ptr(), q.shape, itemsize=FLASH_DTYPES[q.dtype])
    return q.dtype


def _require_cuda(what: str, q: torch.Tensor) -> None:
    if not q.is_cuda:
        raise ValueError(f"{what}: q must be a CUDA tensor, got one on {q.device}")


def _forward_kernel(q, k, v, sm_scale: float, stats: bool):
    """One launch of the forward kernel of q's type → ``(out, lse, out_f32)``. With
    ``stats`` it also stores each row's log-sum-exp, ``(B, H, N)`` f32, and returns the
    output in f32 before its rounding: for bf16 a view of a second ``(B, N, H, D)``
    buffer that the kernel stores too, for f32 the output itself. Without, those two are
    None and the kernel stores nothing more."""
    B, H, N, D = q.shape
    check_flash_scale(sm_scale)
    _require_cuda("flash_lean kernel", q)
    dtype = check_flash_dtypes("flash_lean kernel", {"q": q, "k": k, "v": v})
    tile = QUERY_TILE[dtype]
    if B * H * -(-N // tile) >= 2**31:
        raise ValueError(f"flash_lean kernel: B·H·⌈N/{tile}⌉ work items exceed 2^31")
    f32 = dtype == torch.float32
    out = torch.empty((B, N, H, D), dtype=dtype, device=q.device).transpose(1, 2)
    lse = out_f32 = None
    if stats:
        lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
        out_f32 = out if f32 else torch.empty((B, N, H, D), dtype=torch.float32, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out, lse, out_f32
    lib = _ext.library()
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if stats else 0)
    if not f32:
        pointers += (out_f32.data_ptr() if stats else 0,)
    entry = "tpuhar_flash_attn_f32" if f32 else "tpuhar_flash_attn"
    with torch.cuda.device(q.device):
        status = getattr(lib, entry)(
            *pointers, B, H, N, float(sm_scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _ext.check(status, entry)
    (flash_lean_f32 if f32 else flash_lean).launches += 1
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
    bf16 forward kernel's launches, those of ``flash_lean_with_stats`` included;
    ``flash_lean_f32.launches`` the f32 one's.
    """
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cpu":
        return flash_lean_reference(q, k, v, sm_scale)
    return _forward_kernel(q, k, v, sm_scale, stats=False)[0]


flash_lean.launches = 0


def _require_f32(what: str, q: torch.Tensor) -> None:
    if q.dtype != torch.float32:
        raise ValueError(f"{what}: q must be a float32 tensor, got {q.dtype}")


def flash_lean_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sm_scale: Optional[float] = None):
    """``flash_lean`` on f32 operands only. ``launches`` counts the launches of the f32
    forward kernel (``csrc/flash_attn_f32.cu``: split TF32 on the tensor cores, 128 query
    rows a block), through ``flash_lean`` and ``flash_lean_with_stats`` too."""
    _require_f32("flash_lean_f32", q)
    return flash_lean(q, k, v, sm_scale=sm_scale)


flash_lean_f32.launches = 0


def flash_lean_with_stats(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_lean`` that also returns what the backward kernels read: each row's
    log-sum-exp of the scaled scores, ``(B, H, N)`` f32, which they recompute P from, and
    the output in f32 before its rounding, which the dQ kernel forms ``di`` from (for
    f32 operands the output itself). On a CUDA device it is the same kernel with its
    statistics' pointers set."""
    if q.device.type == "cpu":
        out_f32, lse = _reference_sums(q, k, v, sm_scale)
        return out_f32.to(q.dtype), lse, out_f32
    return _forward_kernel(q, k, v, sm_scale, stats=True)


# ---------------------------------------------------------------------------------------
# Backward: the stock Pallas TPU kernel's dK/dV and dQ kernels
# (jax/experimental/pallas/ops/tpu/flash_attention.py: _flash_attention_bwd_dkv,
# _flash_attention_bwd_dq), ported as the two kernels of csrc/flash_attn_bwd.cu (bf16)
# and of csrc/flash_attn_bwd_f32.cu (f32).
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
    contiguous)``, each a contiguous ``(B, H, N)`` f32 tensor. The grids of both kernels
    of either type, ``⌈N/rows⌉ × H × B`` blocks (128 query rows a block for dQ, which
    walks the key rows in stages of 64, and 128 key rows for dK/dV, which walks the query
    rows in stages of 64), need ``H`` and ``B`` from 1 to 65535 (CUDA's limit on a grid's
    second and third dimensions) and ``N ≥ 1``. ``q``, ``k``, ``v``, the output and
    ``dO`` are held to ``check_flash_operand``: every backward kernel reads q, k, v and dO
    through tensor maps (rows of 128 bytes: 64 bf16 or 32 f32 head columns a box; the f32
    dQ kernel's q and dO in boxes of a block's 128 rows, its k and v in boxes of a
    stage's 64); the dK/dV kernels read lse and di 4 bytes at a time, and the dQ kernels
    the f32 output in 8-byte (bf16) or 16-byte (f32) pieces."""
    for name, (shape, contiguous) in stats.items():
        if tuple(shape) != (B, H, N):
            raise ValueError(f"flash backward kernel: {name} {tuple(shape)} != {(B, H, N)}")
        if not contiguous:
            raise ValueError(f"flash backward kernel: {name} must be contiguous")
    if not (0 < B <= 65535 and 0 < H <= 65535 and N > 0):
        raise ValueError(f"flash backward kernel: grid of {B} batches x {H} heads x {N} tokens out of range")


def _grad_buffer(q: torch.Tensor) -> torch.Tensor:
    """A ``(B, H, N, 64)`` view of a ``(B, N, H, 64)`` buffer of q's type: the layout of
    the projections, so a gradient leaves the kernel as ``(B, N, H·64)`` without a copy."""
    B, H, N, D = q.shape
    return torch.empty((B, N, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)


def _check_backward(operands, stats, out_f32=None) -> torch.dtype:
    """``operands``: name → a ``(B, H, N, 64)`` tensor the kernel reads (q first), all of
    one type the kernels take; ``stats``: name → a ``(B, H, N)`` f32 tensor it reads;
    ``out_f32`` the forward's f32 output, if it reads it. Returns the operands' type,
    which picks the kernel. The device is the wrapper's to check."""
    q = next(iter(operands.values()))
    B, H, N, D = q.shape
    dtype = check_flash_dtypes("flash backward kernel", operands)
    if out_f32 is not None:
        if out_f32.device != q.device or out_f32.dtype != torch.float32:
            raise ValueError(f"flash backward kernel: out_f32 must be a float32 tensor on {q.device}")
        check_flash_operand("out_f32", out_f32.shape, out_f32.stride(), out_f32.data_ptr(), (B, H, N, D), itemsize=4)
    for name, t in stats.items():
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"flash backward kernel: {name} must be a float32 tensor on {q.device}")
    check_flash_grad_operands(B, H, N, {name: (t.shape, t.is_contiguous()) for name, t in stats.items()})
    return dtype


def flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dq, di)`` by the dQ kernel of q's type from the forward's f32 output and ``lse``
    (``flash_lean_with_stats``): ``di = rowsum(O∘dO)`` in f32, ``(B, H, N)``, which the
    dK/dV kernel reads; CUDA tensors only. ``launches`` counts the bf16 kernel's
    launches, ``flash_lean_bwd_dq_f32.launches`` the f32 one's."""
    check_flash_scale(sm_scale)
    _require_cuda("flash backward kernel", q)
    f32 = _check_backward({"q": q, "k": k, "v": v, "dO": dout}, {"lse": lse}, out_f32) == torch.float32
    B, H, N, _ = q.shape
    dq = _grad_buffer(q)
    di = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    entry = "tpuhar_flash_bwd_dq_f32" if f32 else "tpuhar_flash_bwd_dq"
    with torch.cuda.device(q.device):
        status = getattr(_ext.library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out_f32.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B, H, N, float(sm_scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out_f32.stride()[:3],
            *dout.stride()[:3], *dq.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _ext.check(status, entry)
    (flash_lean_bwd_dq_f32 if f32 else flash_lean_bwd_dq).launches += 1
    return dq, di


flash_lean_bwd_dq.launches = 0


def flash_lean_bwd_dkv(q, k, v, dout, lse, di, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` by the dK/dV kernel of q's type from the forward's ``lse`` and the dQ
    kernel's ``di``; CUDA tensors only. ``launches`` counts the bf16 kernel's launches,
    ``flash_lean_bwd_dkv_f32.launches`` the f32 one's."""
    check_flash_scale(sm_scale)
    _require_cuda("flash backward kernel", q)
    f32 = _check_backward({"q": q, "k": k, "v": v, "dO": dout}, {"lse": lse, "di": di}) == torch.float32
    B, H, N, _ = q.shape
    dk, dv = _grad_buffer(q), _grad_buffer(q)
    entry = "tpuhar_flash_bwd_dkv_f32" if f32 else "tpuhar_flash_bwd_dkv"
    with torch.cuda.device(q.device):
        status = getattr(_ext.library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, N, float(sm_scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _ext.check(status, entry)
    (flash_lean_bwd_dkv_f32 if f32 else flash_lean_bwd_dkv).launches += 1
    return dk, dv


flash_lean_bwd_dkv.launches = 0


def flash_lean_bwd_dq_f32(q, k, v, out_f32, dout, lse, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_lean_bwd_dq`` on f32 operands only. ``launches`` counts the launches of the
    f32 dQ kernel (``csrc/flash_attn_bwd_f32.cu``), through ``flash_lean_bwd_dq`` too."""
    _require_f32("flash_lean_bwd_dq_f32", q)
    return flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, sm_scale)


flash_lean_bwd_dq_f32.launches = 0


def flash_lean_bwd_dkv_f32(q, k, v, dout, lse, di, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_lean_bwd_dkv`` on f32 operands only. ``launches`` counts the launches of
    the f32 dK/dV kernel (``csrc/flash_attn_bwd_f32.cu``), through ``flash_lean_bwd_dkv``
    too."""
    _require_f32("flash_lean_bwd_dkv_f32", q)
    return flash_lean_bwd_dkv(q, k, v, dout, lse, di, sm_scale)


flash_lean_bwd_dkv_f32.launches = 0


def flash_lean_backward(q, k, v, out_f32, dout, lse, sm_scale: float):
    """``(dq, dk, dv)`` of ``flash_lean`` for the output gradient ``dout``, from the
    forward's f32 output and log-sum-exp (``flash_lean_with_stats``). A CPU tensor takes
    ``flash_lean_backward_reference``; on a CUDA device the dQ kernel of q's type runs
    first (and leaves ``di = rowsum(O∘dO)``), then the dK/dV kernel; the gradients are
    views of ``(B, N, H, 64)`` buffers of q's type."""
    if q.device.type == "cpu":
        return flash_lean_backward_reference(q, k, v, dout, sm_scale)
    dq, di = flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, sm_scale)
    return (dq, *flash_lean_bwd_dkv(q, k, v, dout, lse, di, sm_scale))


class FlashLean(torch.autograd.Function):
    """``flash_lean`` with a gradient: the forward keeps q, k, v, the f32 output and the
    log-sum-exp; the backward is ``flash_lean_backward`` (the two kernels of q's type on a
    CUDA device, autograd through the plain version on the CPU)."""

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
                check_flash_operand("dO", dout.shape, dout.stride(), dout.data_ptr(), q.shape,
                                    itemsize=FLASH_DTYPES.get(dout.dtype, 2))
            except ValueError:  # a broadcast or packed gradient: the kernels read 16-byte rows
                dout = dout.contiguous()
        dq, dk, dv = flash_lean_backward(q, k, v, out_f32, dout, lse, ctx.sm_scale)
        return dq, dk, dv, None
