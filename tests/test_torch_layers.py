"""Port building blocks vs the JAX package's flax modules, on bridged parameters.

Each flax module is initialised on the CPU, every variable is perturbed (so that
biases, LayerNorm affines and BatchNorm stats are not at their identity init), and
the same numpy tree is loaded into the port module through ``bridge``. f32, atol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from tpuhar.models.imu import IMUTransformerEncoder as JaxIMUTransformerEncoder
from tpuhar.models.layers import ClassifierHead as JaxClassifierHead
from tpuhar.models.layers import CrossAttentionBlock as JaxCrossAttentionBlock
from tpuhar_torch.bridge import load_variables
from tpuhar_torch.models.imu import IMUTransformerEncoder
from tpuhar_torch.models.layers import ClassifierHead, CrossAttentionBlock

torch.set_num_threads(2)

ATOL = 1e-5


def _init(module, seed, *args):
    variables = module.init(jax.random.PRNGKey(seed), *args)
    rng = np.random.default_rng(seed)
    perturbed = jax.tree.map(
        lambda v: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32),
        jax.device_get(variables),
    )
    if "batch_stats" in perturbed:  # keep variances positive
        perturbed["batch_stats"] = jax.tree.map(np.abs, perturbed["batch_stats"])
    return perturbed


@pytest.mark.parametrize(
    "replicate_pos_truncation,stride,n_tokens", [(False, 16, 91), (True, 16, 16), (False, 8, 181)]
)
def test_imu_encoder(replicate_pos_truncation, stride, n_tokens):
    kw = dict(d_model=32, num_heads=4, num_layers=2, stride=stride,
              replicate_pos_truncation=replicate_pos_truncation)
    x = np.random.default_rng(0).standard_normal((2, 6, 250)).astype(np.float32)
    jax_model = JaxIMUTransformerEncoder(**kw)
    variables = _init(jax_model, 0, x)
    want_cls, want_tokens = jax_model.apply(variables, x)
    model = load_variables(IMUTransformerEncoder(**kw), variables)
    cls, tokens = model(torch.from_numpy(x))
    assert tokens.shape == want_tokens.shape == (2, n_tokens, 32)
    np.testing.assert_allclose(tokens.detach().numpy(), np.asarray(want_tokens), atol=ATOL, rtol=0)
    np.testing.assert_allclose(cls.detach().numpy(), np.asarray(want_cls), atol=ATOL, rtol=0)


def test_cross_attention_block():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 7, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jax_block = JaxCrossAttentionBlock(d_model=32, num_heads=4, d_ff=128)
    variables = _init(jax_block, 1, q, kv)
    want = jax_block.apply(variables, q, kv)
    block = load_variables(CrossAttentionBlock(32, 4, 128), variables)
    got = block(torch.from_numpy(q), torch.from_numpy(kv))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_classifier_head(norm):
    x = np.random.default_rng(2).standard_normal((3, 48)).astype(np.float32)
    jax_head = JaxClassifierHead(hidden_dims=(64, 32), num_classes=8, norm=norm)
    variables = _init(jax_head, 2, x)
    want = jax_head.apply(variables, x)
    head = load_variables(ClassifierHead(48, (64, 32), 8, norm=norm), variables)
    got = head(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_bridge_rejects_mismatched_trees():
    x = np.zeros((1, 48), np.float32)
    variables = _init(JaxClassifierHead(hidden_dims=(64,), num_classes=8, norm="layer"), 3, x)
    with pytest.raises(KeyError, match="missing"):
        load_variables(ClassifierHead(48, (64, 32), 8), variables)
    with pytest.raises(ValueError, match="shape"):
        load_variables(ClassifierHead(40, (64,), 8), variables)
