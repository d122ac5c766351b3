"""The port's losses (``tpuhar_torch/losses.py``) against the JAX package's
(``tpuhar/losses.py``) on the same numpy inputs: the value and the gradients with
respect to both embeddings and the SigLIP scalars (``jax.grad`` against autograd), f32,
rtol 1e-5 (atol 1e-7 for gradient elements near 0: only the order of the sums differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar import losses as JL
from tpuhar_torch import losses as L

RTOL, ATOL = 1e-5, 1e-7


def _pair(seed: int, b: int = 6, d: int = 16):
    rng = np.random.default_rng(seed)
    a, v = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    return a / np.linalg.norm(a, axis=1, keepdims=True), v / np.linalg.norm(v, axis=1, keepdims=True)


def _compare(jax_fn, torch_fn, args):
    """Value and gradient of every argument, JAX against PyTorch."""
    want, want_grads = jax.value_and_grad(jax_fn, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    got = torch_fn(*leaves)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    for leaf, g in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quirk", [False, True], ids=["siglip", "quirk"])
@pytest.mark.parametrize("n_valid", [None, 4, 0], ids=["all", "padded", "none_valid"])
def test_siglip_matches_jax(quirk, n_valid):
    imu, video = _pair(0)
    args = (imu, video, np.float32(np.log(10.0) + 0.3), np.float32(-7.5))
    _compare(
        lambda a, v, t, b: JL.siglip_loss(a, v, t, b, quirk_sign_flip=quirk, n_valid=n_valid),
        lambda a, v, t, b: L.siglip_loss(a, v, t, b, quirk_sign_flip=quirk, n_valid=n_valid),
        args,
    )


@pytest.mark.parametrize("n_valid", [None, 4], ids=["all", "padded"])
@pytest.mark.parametrize("temperature", [0.07, 0.5])
def test_infonce_matches_jax(n_valid, temperature):
    imu, video = _pair(1)
    _compare(
        lambda a, v: JL.infonce_loss(a, v, temperature, n_valid=n_valid),
        lambda a, v: L.infonce_loss(a, v, temperature, n_valid=n_valid),
        (imu, video),
    )


def test_n_valid_as_a_tensor_and_padding_ignored():
    """``n_valid`` may be a 0-d tensor (as a batch carries it), and the padded rows do not
    enter the masked losses whatever they hold."""
    imu, video = _pair(2)
    a, v = torch.from_numpy(imu), torch.from_numpy(video)
    junk_a, junk_v = a.clone(), v.clone()
    junk_a[4:], junk_v[4:] = 0.0, 7.0
    t, b = torch.tensor(np.log(10.0)), torch.tensor(-10.0)
    for fn in (lambda x, y, n: L.siglip_loss(x, y, t, b, n_valid=n), lambda x, y, n: L.infonce_loss(x, y, n_valid=n)):
        ref = fn(a[:4], v[:4], None)
        torch.testing.assert_close(fn(junk_a, junk_v, torch.tensor(4, dtype=torch.int32)), ref, rtol=1e-6, atol=0)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((5, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 5)
    for reduction in ("mean", "sum", "none"):
        want = JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), reduction=reduction)
        got = L.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), reduction=reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_evaluation_rows_with_labels_outside_the_classes_match_jax():
    """``cross_entropy_rows`` (the predict steps' per-row loss) on labels outside
    ``[0, C)``: a negative label counts from the end, one outside ``[-C, C)`` gives NaN, as
    the JAX package's ``cross_entropy_loss`` gathers them."""
    import jax.numpy as jnp

    from tpuhar.losses import cross_entropy_loss as jce
    from tpuhar_torch.losses import cross_entropy_rows

    logits = np.array([[1.0, 2.0, 3.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [2.0, 2.0, 0.0]], np.float32)
    labels = np.array([0, 3, -1, -4])
    got = cross_entropy_rows(torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    want = np.asarray(jce(jnp.asarray(logits), jnp.asarray(labels), reduction="none"))
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    assert np.isnan(got[[1, 3]]).all()
