"""The flash kernels' f32 form on the CPU: what the wrappers take and refuse before a
launch (``check_flash_dtypes``, ``_check_backward`` and ``_grad_buffer`` on f32 views:
16-byte rows, so strides in multiples of 4 elements; one type for every operand, bf16 or
f32 and no other; gradients in q's type), and the f32 plain forward against the JAX
package's ``flash_lean`` in interpret mode at videomae_base's N = 1568. The kernels
themselves are held against their float64 plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phases 3 and 12).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.ops.flash_lean import flash_lean as jax_flash_lean
from tpuhar_torch import _ext
from tpuhar_torch.ops.flash_lean import (
    FLASH_DTYPES,
    QUERY_TILE,
    _check_backward,
    _grad_buffer,
    check_flash_dtypes,
    flash_lean,
    flash_lean_bwd_dkv,
    flash_lean_bwd_dkv_f32,
    flash_lean_bwd_dq,
    flash_lean_bwd_dq_f32,
    flash_lean_f32,
    flash_lean_reference,
    flash_lean_with_stats,
)

B, H, N = 2, 3, 100


def _projection_views(dtype=torch.float32, n=N):
    """q, k, v and dO as the ViT hands them over: (B, H, N, 64) views of (B, N, H·64)."""
    return [torch.zeros((B, n, H, 64), dtype=dtype).transpose(1, 2) for _ in range(4)]


def _stats(n=N):
    return {"lse": torch.zeros((B, H, n)), "di": torch.zeros((B, H, n))}


@pytest.mark.parametrize("layout", ["contiguous", "projections", "qkv_split"])
def test_f32_operands_taken(layout):
    """Contiguous tensors, views of the (B, N, H·64) projections, and views of one
    (B, N, 3·H·64) buffer (token stride 3·H·64) are f32 operands the kernels take."""
    if layout == "contiguous":
        q, k, v, dout = (torch.zeros((B, H, N, 64)) for _ in range(4))
    elif layout == "projections":
        q, k, v, dout = _projection_views()
    else:
        qkv = torch.zeros((B, N, 3 * H * 64))
        q, k, v = (t.view(B, N, H, 64).transpose(1, 2) for t in qkv.split(H * 64, dim=-1))
        dout = _projection_views()[0]
    assert check_flash_dtypes("test", {"q": q, "k": k, "v": v}) is torch.float32
    out_f32 = torch.zeros((B, N, H, 64)).transpose(1, 2)
    assert _check_backward({"q": q, "k": k, "v": v, "dO": dout}, {"lse": _stats()["lse"]}, out_f32) is torch.float32
    assert _check_backward({"q": q, "k": k, "v": v, "dO": dout}, _stats()) is torch.float32


def _refused_case(case):
    q, k, v, dout = _projection_views()
    if case == "token_stride_66":  # rows 264 bytes apart: not on 16-byte boundaries
        q = torch.zeros((B, H, N, 66))[..., :64]
    elif case == "base_8_bytes_off":
        q = torch.zeros((B, H, N, 72))[..., 2:66]
    elif case == "broadcast_heads":
        q = torch.zeros((B, 1, N, 64)).expand(B, H, N, 64)
    elif case == "mixed_types":
        k = k.to(torch.bfloat16)
    elif case == "float16":
        q, k, v, dout = (t.to(torch.float16) for t in (q, k, v, dout))
    elif case == "head_dim_32":
        q, k, v, dout = (t[..., :32] for t in (q, k, v, dout))
    return q, k, v, dout


REFUSED = {
    "token_stride_66": "multiples of 4",
    "base_8_bytes_off": "16-byte aligned",
    "broadcast_heads": "broadcast",
    "mixed_types": "must be a torch.float32 tensor",
    "float16": "bfloat16 or float32",
    "head_dim_32": "head_dim",
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_f32_operands_refused(case):
    """The forward's and both backward kernels' checks refuse, before any launch, rows
    that do not start on 16-byte boundaries (an f32 stride of 66 elements, a base 8
    bytes off), a broadcast dimension, operands of two types, float16 and another head
    width."""
    q, k, v, dout = _refused_case(case)
    with pytest.raises(ValueError, match=REFUSED[case]):
        check_flash_dtypes("flash_lean kernel", {"q": q, "k": k, "v": v})
    with pytest.raises(ValueError, match=REFUSED[case]):
        _check_backward({"q": q, "k": k, "v": v, "dO": dout}, _stats())


def test_backward_refuses_a_gradient_of_another_type():
    """dO must be of q's type: a bf16 gradient for f32 operands is refused, not cast."""
    q, k, v, dout = _projection_views()
    with pytest.raises(ValueError, match="dO must be a torch.float32 tensor"):
        _check_backward({"q": q, "k": k, "v": v, "dO": dout.to(torch.bfloat16)}, _stats())
    with pytest.raises(ValueError, match="lse must be a float32 tensor"):
        _check_backward({"q": q, "k": k, "v": v, "dO": dout}, {"lse": _stats()["lse"].double()})


@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_grad_buffer_follows_q(dtype):
    """The gradients are (B, H, N, 64) views of (B, N, H, 64) buffers of q's type."""
    q = _projection_views(dtype)[0]
    buf = _grad_buffer(q)
    assert buf.dtype == dtype and buf.shape == (B, H, N, 64)
    assert buf.transpose(1, 2).is_contiguous()


def test_query_tile_of_each_type():
    """The work-item limit counts the forward kernel's own query rows: 192 for bf16 (the
    persistent grid's items), 128 for f32 (one block each)."""
    assert QUERY_TILE == {torch.bfloat16: 192, torch.float32: 128}
    assert set(QUERY_TILE) == set(FLASH_DTYPES)


def test_wrappers_take_cpu_tensors_plain_and_refuse_to_launch_them():
    """On CPU tensors ``flash_lean_f32`` is the plain version and counts no launch; the
    backward kernels' wrappers, which have no plain path, raise rather than launch on a
    CPU pointer; the f32 wrappers refuse bf16."""
    q, k, v, dout = (torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, 9, 64)).astype(np.float32))
                     for _ in range(4))
    before = flash_lean.launches, flash_lean_f32.launches
    torch.testing.assert_close(flash_lean_f32(q, k, v), flash_lean_reference(q, k, v), rtol=0, atol=0)
    assert (flash_lean.launches, flash_lean_f32.launches) == before
    out, lse, out_f32 = flash_lean_with_stats(q, k, v, 0.125)
    assert out is out_f32  # f32: the output is the f32 output the dQ kernel reads
    for fn, args in ((flash_lean_bwd_dq, (q, k, v, out_f32, dout, lse, 0.125)),
                     (flash_lean_bwd_dkv, (q, k, v, dout, lse, lse, 0.125))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*args)
    bf16 = [t.to(torch.bfloat16) for t in (q, k, v, dout)]
    with pytest.raises(ValueError, match="float32"):
        flash_lean_f32(*bf16[:3])
    with pytest.raises(ValueError, match="float32"):
        flash_lean_bwd_dq_f32(*bf16[:3], out_f32, bf16[3], lse, 0.125)
    with pytest.raises(ValueError, match="float32"):
        flash_lean_bwd_dkv_f32(*bf16, lse, lse, 0.125)


@pytest.mark.parametrize("B_,H_", [(1, 2)])
def test_f32_plain_forward_matches_jax_interpret(B_, H_):
    """The f32 plain forward (the kernel's plain version) against the JAX package's
    ``flash_lean`` in interpret mode at its defaults (392-row query blocks, one full-KV
    block), f32, at videomae_base's N = 1568: rtol 1e-5 (the same function, its sums in
    another order)."""
    rng = np.random.default_rng(24)
    q, k, v = (rng.standard_normal((B_, H_, 1568, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_flash_lean(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = flash_lean(*(torch.from_numpy(t) for t in (q, k, v)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_kernel_attributes_raise_cleanly_without_cuda(monkeypatch):
    """``_ext.kernel_attributes`` refuses a name the kernel table does not hold, and without
    a CUDA device raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_ext, "library", lambda: pytest.fail("built the library without a CUDA device"))
    with pytest.raises(ValueError, match="not one of"):
        _ext.kernel_attributes("flash_attn")
    for name in _ext.ATTRIBUTE_KERNELS:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            _ext.kernel_attributes(name)
