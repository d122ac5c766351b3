"""The port's attention (``tpuhar_torch/ops/{flash_lean,attention}.py``) against the JAX
package's on the CPU: the same numpy inputs, JAX's Pallas kernel in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.ops.attention import FlashSelfAttention as JaxFlashSelfAttention
from tpuhar.ops.attention import _reference_attention as jax_reference_attention
from tpuhar.ops.attention import flash_mha as jax_flash_mha
from tpuhar.ops.flash_lean import flash_lean as jax_flash_lean
from tpuhar_torch.bridge import load_variables
from tpuhar_torch.ops.attention import FlashSelfAttention
from tpuhar_torch.ops.flash_lean import flash_lean, flash_lean_reference

torch.set_num_threads(2)


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, size=shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize(
    "B,H,N,D,bq,bk",
    [  # the shapes of tests/test_flash_lean.py
        (2, 2, 448, 64, 224, 224),
        (1, 2, 1568, 64, 224, 256),  # the serving token count
        (1, 1, 1568, 64, 392, 1792),  # the JAX defaults: one full-KV tile
        (2, 1, 100, 32, 64, 64),
        (1, 1, 224, 128, 224, 224),
    ],
)
def test_flash_lean_matches_jax_f32(B, H, N, D, bq, bk):
    """The same math in f32 with another sum order: 2e-5 abs and rel, as JAX's own test.
    The TPU kernel's block sizes change its tiling only; the port takes none."""
    q, k, v = _qkv((B, H, N, D), N + D)
    want = np.asarray(jax_flash_lean(q, k, v, block_q=bq, block_k=bk, interpret=True))
    got = flash_lean(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (B, H, N, D)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_flash_lean_matches_jax_bf16():
    """bf16 inputs at the JAX defaults, where both compute one full-KV tile: the scores,
    the softmax and both sums are f32 and only P and the output round to bf16, so the
    results differ by at most one bf16 rounding of the output (2^-8 relative)."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv((1, 2, 448, 64), 3))
    want = np.asarray(jax_flash_lean(q, k, v, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in (q, k, v))
    got = flash_lean(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2**-8 * np.abs(want).max(), rtol=2**-8)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("kernel", ["lean", "library"])
def test_flash_mha_matches_jax_reference(use_flash, kernel):
    """Every branch of JAX's ``flash_mha`` computes what the port's one ``flash_lean``
    does; on the CPU JAX takes its XLA reference. f32 with another sum order."""
    q, k, v = _qkv((2, 3, 40, 16), 7)
    want = np.asarray(jax_flash_mha(q, k, v, sm_scale=0.3, use_flash=use_flash, kernel=kernel))
    np.testing.assert_allclose(want, np.asarray(jax_reference_attention(q, k, v, 0.3)), rtol=0, atol=0)
    got = flash_lean(*map(torch.from_numpy, (q, k, v)), sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("B,N,D,H", [(2, 24, 96, 3), (1, 33, 128, 2)])
def test_flash_self_attention_matches_jax(B, N, D, H):
    """Both packages on the same flax parameters; JAX's module takes its XLA path on
    the CPU, the port's the kernel's plain version. The output is ``(B, N, D)``."""
    x = np.random.default_rng(11).normal(0, 1, (B, N, D)).astype(np.float32)
    net = JaxFlashSelfAttention(num_heads=H, qkv_features=D)
    variables = jax.device_get(net.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(12)
    variables = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), variables)
    want = np.asarray(net.apply(variables, x))
    model = load_variables(FlashSelfAttention(D, H), variables)
    got = model(torch.from_numpy(x))
    assert got.shape == (B, N, D)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)


def test_flash_lean_reference_is_the_one_tile_math():
    """On the CPU ``flash_lean`` is its plain version, bit for bit, in f32 and bf16 and
    with a given scale; in f32 that is softmax attention to 1e-5 of a float64 one."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 70, 64), 13))
    for dtype in (torch.float32, torch.bfloat16):
        a, b, c = q.to(dtype), k.to(dtype), v.to(dtype)
        torch.testing.assert_close(flash_lean(a, b, c), flash_lean_reference(a, b, c), rtol=0, atol=0)
        torch.testing.assert_close(
            flash_lean(a, b, c, sm_scale=0.05), flash_lean_reference(a, b, c, 0.05), rtol=0, atol=0
        )
    q64, k64, v64 = q.double(), k.double(), v.double()
    want = torch.softmax(q64 @ k64.mT / 8.0, dim=-1) @ v64
    torch.testing.assert_close(flash_lean(q, k, v).double(), want, rtol=1e-5, atol=1e-5)
