"""The port's video ops (``tpuhar_torch/ops/video.py``) against the JAX package's
(``tpuhar/ops/video.py:38-89``) on the same numpy inputs.

- ``space_to_depth_clip`` and ``select_uniform_frames``: equal (a copy; integer indices
  rounded half to even on both sides).
- ``prepare_clip(s2d=...)``: 1e-6 absolute (f32 ``x·scale + offset``; the constants are
  folded by each framework).
- ``resize_clip``: bilinear with half-pixel centres, antialiased when shrinking, as
  ``jax.image.resize`` (``F.interpolate(antialias=True)`` against JAX's weight matrix:
  the same triangle filter, summed in another order): 2e-4 absolute on uint8 pixels
  (0-255) and on float clips of unit scale 1e-6 relative to their range.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.ops import video as J
from tpuhar_torch.ops import video as V

RESIZE_ATOL_U8 = 2e-4


def _clip(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("s", [2, 4])
def test_space_to_depth_and_prepare_clip_match_jax(s):
    x = _clip((2, 3, 16, 24, 3))
    got = V.space_to_depth_clip(torch.from_numpy(x), s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.space_to_depth_clip(jnp.asarray(x), s)))
    prepared = V.prepare_clip(torch.from_numpy(x), s2d=s)
    assert prepared.shape == (2, 3, 16 // s, 24 // s, 3 * s * s) and prepared.dtype == torch.float32
    np.testing.assert_allclose(prepared.numpy(), np.asarray(J.prepare_clip(jnp.asarray(x), s2d=s)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(V.prepare_clip(torch.from_numpy(x)).numpy(), np.asarray(J.prepare_clip(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(48, 40), (24, 10), (16, 24), (7, 33)])
def test_resize_clip_matches_jax(hw):
    x = _clip((2, 3, 16, 24, 3), seed=1)
    got = V.resize_clip(torch.from_numpy(x), *hw)
    want = np.asarray(J.resize_clip(jnp.asarray(x), *hw))
    assert got.shape == want.shape == (2, 3, *hw, 3) and got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_ATOL_U8)
    xf = np.random.default_rng(2).standard_normal((1, 2, 16, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(V.resize_clip(torch.from_numpy(xf), *hw).numpy(),
                               np.asarray(J.resize_clip(jnp.asarray(xf), *hw)), rtol=0, atol=1e-6 * np.ptp(xf))
    with pytest.raises(ValueError, match="bilinear"):
        V.resize_clip(torch.from_numpy(x), *hw, method="nearest")


@pytest.mark.parametrize("total,start,window,num", [
    (300, 0, 150, 16), (300, 290, 150, 16), (10, 3, 150, 16), (1, 0, 150, 16), (500, 499, 150, 8),
    (40, -5, 30, 16), (100, 20, 1, 4), (100, 10, 17, 1),
])
def test_select_uniform_frames_matches_jax(total, start, window, num):
    want = np.asarray(J.select_uniform_frames(total, jnp.asarray(start), window, num))
    for given in (start, torch.tensor(start)):
        got = V.select_uniform_frames(total, given, window, num)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
