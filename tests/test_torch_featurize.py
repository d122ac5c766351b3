"""Port featurizer (``tpuhar_torch.ops``) vs the JAX package's, on the CPU.

The same numpy windows go through the port's plain path (which a CPU tensor takes
in ``featurize_windows_auto``), JAX's ``featurize_windows`` and JAX's Pallas kernel
in interpret mode. Tolerance 1e-5 abs: f32 throughout, only the order of the
mean/variance sums differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.ops.featurize import featurize_windows as jax_featurize_windows
from tpuhar.ops.fused_window import featurize_windows_pallas
from tpuhar_torch.ops.featurize import featurize_windows
from tpuhar_torch.ops.fused_window import featurize_windows_auto

torch.set_num_threads(2)

ATOL = 1e-5

# the four cases of tests/test_pallas_ops.py, the T=250 default, and k=4 (bumped to 5)
CASES = [
    (4, 250, 8000.0, {}),
    (3, 128, 8000.0, {}),
    (2, 250, 8000.0, {"kernel_size": 1}),
    (2, 250, 8000.0, {"normalize": False}),
    (2, 250, 100.0, {"racc": 100.0, "rgyro": 2.0}),
    (2, 250, 8000.0, {"kernel_size": 4}),
]


def _raw(B, T, sigma, seed=0):
    return np.random.default_rng(seed).normal(0, sigma, (B, T, 6)).astype(np.float32)


@pytest.mark.parametrize("B,T,sigma,kw", CASES)
def test_matches_jax_and_pallas(B, T, sigma, kw):
    raw = _raw(B, T, sigma)
    got = featurize_windows_auto(torch.from_numpy(raw), **kw).numpy()
    assert got.shape == (B, 6, T)
    want = np.asarray(jax_featurize_windows(jnp.asarray(raw), **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    pallas = np.asarray(featurize_windows_pallas(jnp.asarray(raw), interpret=True, **kw))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel_size", [3, 7])
def test_plain_path_other_kernel_sizes(kernel_size):
    """The plain path takes any median size, as JAX's plain path does."""
    raw = _raw(2, 250, 8000.0, seed=kernel_size)
    got = featurize_windows(torch.from_numpy(raw), kernel_size=kernel_size).numpy()
    want = np.asarray(jax_featurize_windows(jnp.asarray(raw), kernel_size=kernel_size))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
