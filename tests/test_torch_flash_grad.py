"""The flash attention's gradient on the CPU: ``FlashLean`` (the port's
``torch.autograd.Function``, whose backward is the two Hopper kernels on a card and
autograd through the plain version here), autograd through ``flash_lean_reference``, and
``jax.grad`` of the JAX package's ``_reference_attention`` (what ``flash_mha`` runs off
the TPU), on the same numpy inputs, f32: dq, dk and dv within rtol 1e-5 (atol 1e-6 for
elements near 0). The kernels themselves are held against the plain version on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.ops.attention import _reference_attention
from tpuhar_torch.ops.attention import FlashSelfAttention
from tpuhar_torch.ops.flash_lean import (
    FlashLean,
    flash_lean,
    flash_lean_backward,
    flash_lean_backward_reference,
    flash_lean_bwd_dkv,
    flash_lean_bwd_dq,
    flash_lean_reference,
    flash_lean_with_stats,
)

RTOL, ATOL = 1e-5, 1e-6


def _case(B, H, N, seed=0, D=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("N", [8, 100, 1568])  # 1568: videomae_base's tokens
def test_function_gradient_matches_autograd_and_jax(N):
    q, k, v, dout = _case(2, 3, N)
    scale = 0.125

    def jax_loss(q, k, v):
        return jnp.sum(_reference_attention(q, k, v, scale) * dout)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    before = flash_lean.launches, flash_lean_bwd_dkv.launches, flash_lean_bwd_dq.launches
    out = FlashLean.apply(*leaves, scale)
    out.backward(torch.from_numpy(dout))
    assert (flash_lean.launches, flash_lean_bwd_dkv.launches, flash_lean_bwd_dq.launches) == before
    plain = flash_lean_backward_reference(*(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(dout), scale)
    for name, leaf, p, w in zip("qkv", leaves, plain, want):
        np.testing.assert_allclose(leaf.grad.numpy(), p.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"d{name} vs plain")
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=f"d{name} vs JAX")
    torch.testing.assert_close(out.detach(), flash_lean_reference(*(torch.from_numpy(t) for t in (q, k, v)), scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stats_and_backward_entry_on_cpu(dtype):
    """``flash_lean_with_stats`` gives the plain output, ``logsumexp`` of the scaled
    scores and the output before its rounding to the inputs' type; ``flash_lean_backward``
    on CPU tensors is the plain backward."""
    q, k, v, dout = (torch.from_numpy(t).to(dtype) for t in _case(1, 2, 40, seed=1))
    out, lse, out_f32 = flash_lean_with_stats(q, k, v, 0.2)
    torch.testing.assert_close(out, flash_lean_reference(q, k, v, 0.2), rtol=0, atol=0)
    assert out_f32.dtype == lse.dtype == torch.float32 and torch.equal(out_f32.to(dtype), out)
    torch.testing.assert_close(lse, torch.logsumexp((q.float() @ k.float().mT) * 0.2, dim=-1), rtol=1e-6, atol=1e-6)
    for got, want in zip(flash_lean_backward(q, k, v, out_f32, dout, lse, 0.2),
                         flash_lean_backward_reference(q, k, v, dout, 0.2)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_self_attention_routes_by_grad_mode():
    """With grad enabled the module's attention has a gradient (``FlashLean``); under
    ``inference_mode`` it is ``flash_lean``; both give the same output."""
    torch.manual_seed(0)
    attn = FlashSelfAttention(128, 2)
    x = torch.randn(2, 9, 128, requires_grad=True)
    y = attn(x)
    assert y.grad_fn is not None
    y.square().sum().backward()
    assert x.grad is not None and attn.query.weight.grad is not None and attn.key.weight.grad is not None
    with torch.inference_mode():
        torch.testing.assert_close(attn(x.detach()), y.detach(), rtol=0, atol=0)
