"""The port's sequence featurization (``tpuhar_torch/ops/featurize.py``: Fourier
resampling, the masked z-score, padded windowing and the batched ``preprocess_sequence``)
against the JAX package's (``tpuhar/ops/featurize.py``), on the CPU.

Tolerances: ``fourier_resample`` within 1e-5 × max|x| (both f32 FFTs, pocketfft's and
XLA's, round differently) and against ``scipy.signal.resample`` in float64 within 1e-4
× max|x|; the z-score and ``preprocess_sequence`` at 1e-5 absolute (unit-variance
outputs; only the order of the f32 sums differs); windowing, lengths and counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from tpuhar.ops import featurize as jf
from tpuhar_torch.ops import featurize as pf

torch.set_num_threads(2)

ATOL = 1e-5


def _raw(shape, sigma=8000.0, seed=0):
    return np.random.default_rng(seed).normal(0, sigma, shape).astype(np.float32)


@pytest.mark.parametrize("n,n_target", [(300, 150), (301, 150), (300, 451), (301, 600), (256, 256), (255, 100)])
def test_fourier_resample_matches_jax_and_scipy(n, n_target):
    x = _raw((n, 6), sigma=1.0, seed=n)
    got = pf.fourier_resample(torch.from_numpy(x), n_target).numpy()
    want = np.asarray(jf.fourier_resample(jnp.asarray(x), n_target))
    assert got.shape == want.shape == (n_target, 6) and got.dtype == np.float32
    scale = np.abs(x).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    ref = scipy.signal.resample(x.astype(np.float64), n_target, axis=0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)


def test_fourier_resample_takes_a_batch():
    x = _raw((3, 300, 6), sigma=1.0)
    got = pf.fourier_resample(torch.from_numpy(x), 200).numpy()
    for b in range(3):
        np.testing.assert_allclose(got[b], pf.fourier_resample(torch.from_numpy(x[b]), 200).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("length", [1, 100, 255, 256])
def test_masked_zscore_matches_jax(length):
    x = _raw((256, 6), sigma=3.0)
    x[length:] = 0.0
    got = pf.masked_zscore_time(torch.from_numpy(x), torch.tensor(length)).numpy()
    want = np.asarray(jf.masked_zscore_time(jnp.asarray(x), jnp.asarray(length)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_masked_zscore_takes_a_length_per_row():
    x = _raw((3, 256, 6), sigma=3.0)
    lengths = np.array([256, 100, 7])
    got = pf.masked_zscore_time(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    for b, n in enumerate(lengths):
        want = np.asarray(jf.masked_zscore_time(jnp.asarray(x[b]), jnp.asarray(n)))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("T,window,stride", [(256, 250, 125), (1024, 250, 125), (512, 100, 30), (100, 250, 125)])
def test_windowing_matches_jax(T, window, stride):
    x = _raw((T, 6), seed=T)
    assert pf.num_windows(T, window, stride) == jf.num_windows(T, window, stride)
    if T >= window:
        np.testing.assert_array_equal(pf.window_slice(torch.from_numpy(x), window, stride).numpy(),
                                      np.asarray(jf.window_slice(jnp.asarray(x), window, stride)))
    else:
        assert pf.window_slice(torch.from_numpy(x), window, stride).shape == (0, window, 6)
    padded = pf.pad_to_window(x, window)
    np.testing.assert_array_equal(padded, jf.pad_to_window(x, window))
    assert padded.dtype == x.dtype
    for length in (0, 1, window - 1, window, max(T, window) - 1, max(T, window)):
        xp = pf.pad_to_window(x, window)
        got_w, got_n = pf.window_slice_padded(torch.from_numpy(xp), torch.tensor(length), window, stride)
        want_w, want_n = jf.window_slice_padded(jnp.asarray(xp), jnp.asarray(length), window, stride)
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
        assert got_n.dtype == torch.int32 and int(got_n) == int(want_n), length


@pytest.mark.parametrize("kw", [
    {},
    {"kernel_size": 1},
    {"kernel_size": 4},
    {"normalize": False},
    {"racc": 100.0, "rgyro": 2.0, "stride": 50},
])
def test_batched_preprocess_sequence_matches_jax_vmap(kw):
    """One call on a bucket of sequences (each zero past its length) against JAX's
    ``jax.jit(jax.vmap(preprocess_sequence))``, the form the JAX preprocessor runs.

    A one-sample sequence is held apart: its z-score is ``(x - mean) / (0 + 1e-8)`` with
    ``x == mean``, so any rounding of the mean is magnified 1e8 times (XLA's fused
    reduction gives up to ±1 there without the median filter). The port gives the
    exact 0."""
    kw = {"window": 250, "stride": 125, **kw}
    bucket = 1024
    lengths = np.array([1024, 700, 300, 250, 120, 2], np.int32)
    raw = _raw((len(lengths), bucket, 6), seed=7)
    for b, n in enumerate(lengths):
        raw[b, n:] = 0.0
    got_w, got_n = pf.preprocess_sequence(torch.from_numpy(raw), torch.from_numpy(lengths), **kw)
    batched = jax.jit(jax.vmap(lambda r, n: jf.preprocess_sequence(r, n, **kw)))
    want_w, want_n = (np.asarray(a) for a in batched(jnp.asarray(raw), jnp.asarray(lengths)))
    assert got_w.shape == want_w.shape and got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    for b, n in enumerate(want_n):  # the valid windows; the rest are the caller's to drop
        np.testing.assert_allclose(got_w[b, :n].numpy(), want_w[b, :n], rtol=0, atol=ATOL)
    one = np.zeros((1, bucket, 6), np.float32)
    one[0, 0] = raw[0, 0]
    w, n = pf.preprocess_sequence(torch.from_numpy(one), torch.tensor([1]), **kw)
    assert n.tolist() == [1]
    if kw.get("normalize", True):
        assert not w.any()
    # one unbatched sequence is the same function
    w1, n1 = pf.preprocess_sequence(torch.from_numpy(raw[1]), torch.tensor(int(lengths[1])), **kw)
    assert int(n1) == int(want_n[1])
    np.testing.assert_allclose(w1[: int(n1)].numpy(), want_w[1, : want_n[1]], rtol=0, atol=ATOL)
