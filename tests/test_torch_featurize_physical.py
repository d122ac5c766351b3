"""``featurize_windows(..., already_physical=True)``: windows already in g and deg/s
skip the unit scaling. Against the JAX package's function with the same flag, on the
CPU, within 1e-5 absolute (``tests/test_torch_featurize.py``'s tolerance: f32
throughout, only the order of the mean/variance sums differs). The default path is
unchanged: raw counts through it still match JAX's default, and equal their physical
units through the flag bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.ops.featurize import featurize_windows as jax_featurize_windows
from tpuhar_torch.ops.featurize import featurize_windows, raw_to_physical

torch.set_num_threads(2)

ATOL = 1e-5


def _physical(B, T, seed):
    """Windows in g (accelerometer, ~1 g) and deg/s (gyroscope, ~200 deg/s)."""
    rng = np.random.default_rng(seed)
    acc = rng.normal(0.0, 1.0, (B, T, 3))
    gyro = rng.normal(0.0, 200.0, (B, T, 3))
    return np.concatenate([acc, gyro], axis=-1).astype(np.float32)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("kernel_size", [3, 5])
@pytest.mark.parametrize("T", [37, 250])
@pytest.mark.parametrize("B", [1, 8])
def test_featurize_already_physical_matches_jax(B, T, kernel_size, normalize):
    x = _physical(B, T, seed=B * 1000 + T + kernel_size)
    kw = dict(kernel_size=kernel_size, normalize=normalize)
    got = featurize_windows(torch.from_numpy(x), already_physical=True, **kw).numpy()
    assert got.shape == (B, 6, T)
    want = np.asarray(jax_featurize_windows(jnp.asarray(x), already_physical=True, **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("normalize", [True, False])
def test_featurize_default_unchanged(normalize):
    """Raw counts through the default path: JAX's default within 1e-5, and bit for bit
    what their physical units give through ``already_physical=True``."""
    raw = np.random.default_rng(7).normal(0, 8000.0, (8, 250, 6)).astype(np.float32)
    got = featurize_windows(torch.from_numpy(raw), normalize=normalize)
    want = np.asarray(jax_featurize_windows(jnp.asarray(raw), normalize=normalize))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    phys = raw_to_physical(torch.from_numpy(raw), 16384.0, 16.4)
    assert torch.equal(featurize_windows(phys, normalize=normalize, already_physical=True), got)
