"""Port fused 3×3 conv (plain path on the CPU) vs the JAX package's Pallas kernel in
interpret mode, and ``fold_bn``.

f32, atol 1e-4: both sides accumulate in f32. The frame counts are the smallest the
Pallas kernel's layout takes at each plane size (its row blocks need ``N·S·S``
divisible by 16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.ops.conv3x3 import conv3x3_bn_act as jax_conv3x3_bn_act
from tpuhar.ops.conv3x3 import fold_bn as jax_fold_bn
from tpuhar_torch.ops.conv3x3 import conv3x3_bn_act, fold_bn

torch.set_num_threads(2)

ATOL = 1e-4


def _case(n, s, c, seed):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(n, s, s, c).astype(np.float32),
        (rng.randn(3, 3, c, c) * 0.05).astype(np.float32),
        (rng.rand(c) + 0.5).astype(np.float32),
        (rng.randn(c) * 0.1).astype(np.float32),
        rng.randn(n, s, s, c).astype(np.float32),
    )


@pytest.mark.parametrize("residual,relu", [(False, True), (True, True), (True, False)])
@pytest.mark.parametrize("s,n", [(4, 2), (7, 16), (14, 4)])
def test_matches_pallas(s, n, residual, relu):
    x, k, scale, bias, res = _case(n, s, 128, seed=s)
    res = res if residual else None
    want = jax_conv3x3_bn_act(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res), relu=relu,
        force_pallas=True, interpret=True,
    )
    got = conv3x3_bn_act(
        torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(scale),
        torch.from_numpy(bias), residual=None if res is None else torch.from_numpy(res),
        relu=relu,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(0)
    scale, bias, mean = (rng.randn(64).astype(np.float32) for _ in range(3))
    var = (rng.rand(64) + 0.1).astype(np.float32)
    got = fold_bn(*(torch.from_numpy(a) for a in (scale, bias, mean, var)))
    want = jax_fold_bn(*(jnp.asarray(a) for a in (scale, bias, mean, var)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    # the worked example of tests/test_conv3x3.py::test_fold_bn
    s, b = fold_bn(*(torch.tensor([v]) for v in (2.0, 1.0, 0.5, 4.0)), eps=0.0)
    assert s.item() == 1.0 and b.item() == 0.5
