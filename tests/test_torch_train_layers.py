"""The port's training modes of its building blocks (``tpuhar_torch/models/layers.py``)
against flax (``tpuhar/models/layers.py``) on the same numpy inputs, f32.

BatchNorm and ProjectionHead in train mode: the outputs of two calls and the running
statistics after them (flax's momentum 0.9 and biased batch variance), 1e-5. And
``l2_normalize``; dropout's rate and 1/(1−p) scaling, the attention-weight mask shared
over batch and heads, its dependence on the generator alone, and eval as the identity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tpuhar.models import layers as jl
from tpuhar_torch.bridge import load_variables, variables_to_numpy
from tpuhar_torch.models import layers

torch.set_num_threads(2)

TOL = 1e-5


def _calls(seed: int, shape):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 3 + 1).astype(np.float32) for _ in range(2)]


def _flax_train(module, variables, xs, **kwargs):
    """Two calls of a flax module in train mode, threading its batch statistics."""
    outs = []
    for x in xs:
        y, mutated = module.apply(variables, jnp.asarray(x), mutable=["batch_stats"], **kwargs)
        variables = {"params": variables["params"], "batch_stats": jax.device_get(mutated["batch_stats"])}
        outs.append(np.asarray(y))
    return outs, variables


@pytest.mark.parametrize("shape", [(8, 12), (2, 5, 12)], ids=["2d", "3d"])
def test_batchnorm_train_matches_flax(shape):
    xs = _calls(0, shape)
    flax_bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = jax.device_get(flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), use_running_average=False))
    rng = np.random.default_rng(1)
    variables["params"] = {"scale": rng.uniform(0.5, 1.5, 12).astype(np.float32),
                           "bias": rng.standard_normal(12).astype(np.float32)}
    want, after = _flax_train(flax_bn, variables, xs, use_running_average=False)
    bn = load_variables(layers.BatchNorm(12), variables)
    got = [bn(torch.from_numpy(x), train=True).detach().numpy() for x in xs]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(), after["batch_stats"][name], rtol=TOL, atol=TOL)
    # eval normalizes with the running statistics and leaves them alone
    y = flax_bn.apply(after, jnp.asarray(xs[0]), use_running_average=True)
    np.testing.assert_allclose(bn(torch.from_numpy(xs[0])).numpy(), np.asarray(y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(bn.mean.numpy(), after["batch_stats"]["mean"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("norm", ["batch", "layer"])
def test_projection_head_train_matches_flax(norm):
    xs = _calls(2, (8, 20))
    head = jl.ProjectionHead(16, 6, norm=norm)
    variables = jax.device_get(head.init(jax.random.PRNGKey(0), jnp.asarray(xs[0])))
    if norm == "batch":
        want, after = _flax_train(head, variables, xs, train=True)
    else:
        want, after = [np.asarray(head.apply(variables, jnp.asarray(x), train=True)) for x in xs], variables
    port = load_variables(layers.ProjectionHead(20, 16, 6, norm=norm), variables)
    got = [port(torch.from_numpy(x), train=True).detach().numpy() for x in xs]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    port_stats = variables_to_numpy(port)["batch_stats"]
    assert set(port_stats) == set(after.get("batch_stats", {}))
    for k, v in after.get("batch_stats", {}).get("bn", {}).items():
        np.testing.assert_allclose(port_stats["bn"][k], v, rtol=TOL, atol=TOL, err_msg=k)


def test_l2_normalize_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 9)).astype(np.float32)
    x[2] = 0.0  # the eps floor: a zero row stays zero
    np.testing.assert_allclose(
        layers.l2_normalize(torch.from_numpy(x)).numpy(), np.asarray(jl.l2_normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-7
    )


def test_dropout_rate_scaling_and_generator():
    x = torch.ones(200_000)
    y = layers.dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(y, layers.dropout(x, 0.25, torch.Generator().manual_seed(0)))  # same seed, same mask
    assert not torch.equal(y, layers.dropout(x, 0.25, torch.Generator().manual_seed(1)))
    assert layers.dropout(x, 0.0, None) is x


def test_attention_dropout_mask_shared_over_batch_and_heads():
    """With the query and key projections zeroed every weight is 1/Nk, and with the value
    projection's bias at 1 every value is 1, so each output of the attention before its
    ``out`` projection is the sum of one row of the dropout mask: equal over batch and
    heads (flax's ``broadcast_dropout``), varying over the queries."""
    attn = layers.MultiHeadDotProductAttention(16, 4, dropout_rate=0.5)
    with torch.no_grad():
        for dense in (attn.query, attn.key, attn.value):
            dense.weight.zero_()
            dense.bias.zero_()
        attn.value.bias.fill_(1.0)
    ctx = {}
    attn.out.register_forward_hook(lambda module, args, out: ctx.update(x=args[0]))
    x = torch.randn(3, 32, 16)
    attn(x, x)
    torch.testing.assert_close(ctx["x"], torch.ones_like(ctx["x"]))  # eval: no dropout
    attn(x, x, train=True, generator=torch.Generator().manual_seed(0))
    per_query = ctx["x"][:1, :, :1]  # batch 0, head 0
    torch.testing.assert_close(ctx["x"], per_query.expand_as(ctx["x"]), rtol=0, atol=1e-6)
    assert per_query.std() > 0.05  # the mask differs between queries


def test_encoder_block_train_draws_from_the_generator():
    torch.manual_seed(0)
    block = layers.TransformerEncoderBlock(16, 4, 32, dropout=0.1)
    x = torch.randn(2, 7, 16)
    a = block(x, train=True, generator=torch.Generator().manual_seed(3))
    b = block(x, train=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert not torch.equal(a, block(x, train=True, generator=torch.Generator().manual_seed(4)))
    assert torch.equal(block(x), block(x, train=False, generator=torch.Generator().manual_seed(3)))
