"""The port's int8 ResNet-18 PTQ (``tpuhar_torch/ops/quant.py``) vs the JAX package's
``tpuhar/ops/quant.py:89-276``, on the same numpy inputs.

A flax ResNet-18 at its full widths with random BatchNorm parameters and statistics, on
4 frames of 64² (the JAX tests' size). Both packages get the same normalized frames,
made once by the JAX package's ``normalize_clip`` (the two packages' f32
normalizations may differ in the last bit, which moves a stem code).

Tolerances, with their reasons:
- the pieces the card runs through its kernels, on their plain versions: the 7×7 stem
  as ``stem_im2col`` + ``int8_gemm``, the 1×1 downsample as ``int8_gemm`` on every other
  pixel, the 3×3 conv with explicit ``(1, 1)`` padding, the max-pool of int8 codes
  through f16: each equal bit for bit to JAX's ``int8_conv``/``nn.max_pool``;
- ``calibrate_resnet18``: f32 convs in another sum order, site absmax to 1e-5 relative;
- ``quantize_resnet18`` on the same statistics: ``w_q`` equal, or off by one on at most
  0.1% of entries (a weight on a rounding tie after a BatchNorm fold), scales and
  biases to 1e-6;
- both forwards on JAX's tree carried over: every int8 product is exact in both, so the
  features agree to the f32 sum order of the pooled mean and the residual adds, rtol and
  atol 1e-5;
- resident against baseline on the port alone: mean drift < 0.02 and correlation >
  0.999, the JAX package's bounds on its own test's net (``tests/test_quant.py:217``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from tpuhar.models.video import ResNet18
from tpuhar.ops import quant as Q
from tpuhar.ops.video import normalize_clip
from tpuhar_torch.bridge import quantized_tree_from_numpy
from tpuhar_torch.ops import quant as TQ
from tpuhar_torch.ops.conv3x3 import conv3x3_i8_reference, pack_conv3x3_i8
from tpuhar_torch.ops.stem import int8_gemm

torch.set_num_threads(2)

BLOCKS = [f"layer{li}_{bi}" for li in range(4) for bi in range(2)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def resnet():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    frames = np.array(jax.jit(normalize_clip)(u8[None])[0])
    net = ResNet18()
    v = jax.device_get(jax.jit(lambda k, x: net.init(k, x, train=False))(jax.random.PRNGKey(0), frames))
    params, stats = v["params"], v["batch_stats"]

    def randomize(p, s):
        if "scale" in p and "mean" in s:  # a BatchNorm: parameters and statistics
            n = p["scale"].shape[0]
            return ({"scale": rng.uniform(0.5, 1.5, n).astype(np.float32), "bias": rng.normal(0, 0.1, n).astype(np.float32)},
                    {"mean": rng.normal(0, 0.1, n).astype(np.float32), "var": rng.uniform(0.5, 2.0, n).astype(np.float32)})
        pairs = {k: randomize(p[k], s[k]) for k in s}
        return {**p, **{k: a for k, (a, _) in pairs.items()}}, {k: b for k, (_, b) in pairs.items()}

    params, stats = randomize(dict(params), dict(stats))
    act = Q.calibrate_resnet18(params, stats, frames)
    tree = jax.device_get(Q.quantize_resnet18(params, stats, act))
    return params, stats, frames, act, tree


def test_stem_im2col_and_int8_gemm_equal_jax_int8_conv():
    rng = np.random.default_rng(1)
    x = rng.integers(-127, 128, (2, 30, 30, 3), dtype=np.int8)
    w = rng.integers(-127, 128, (7, 7, 3, 64), dtype=np.int8)
    ws = (rng.random(64) * 1e-3).astype(np.float32)
    bias = rng.normal(0, 1, 64).astype(np.float32)
    xs = np.float32(0.0173)
    want = np.asarray(
        nn.relu(Q.int8_conv(jnp.asarray(x), jnp.asarray(w), xs, jnp.asarray(ws), strides=(2, 2), padding=[(3, 3), (3, 3)]) + bias)
    )
    cols = TQ.stem_im2col(_t(x))
    assert cols.shape == (2, 15, 15, 192) and cols.dtype == torch.int8
    assert not cols[..., 147:].any()
    w_packed = torch.nn.functional.pad(_t(w).reshape(147, 64).T, (0, 45)).contiguous()
    got = int8_gemm(cols, w_packed, torch.tensor(xs) * _t(ws), _t(bias), relu=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [8, 7])
def test_downsample_equals_jax_int8_conv(size):
    rng = np.random.default_rng(size)
    x = rng.integers(-127, 128, (2, size, size, 64), dtype=np.int8)
    w = rng.integers(-127, 128, (1, 1, 64, 128), dtype=np.int8)
    ws = (rng.random(128) * 1e-3).astype(np.float32)
    xs = np.float32(0.031)
    want = np.asarray(Q.int8_conv(jnp.asarray(x), jnp.asarray(w), xs, jnp.asarray(ws), strides=(2, 2), padding="VALID"))
    ds = {"w_packed": _t(w).reshape(64, 128).T.contiguous(), "xs_ws": torch.tensor(xs) * _t(ws), "bias": torch.zeros(128)}
    got = TQ._downsample(_t(x), ds, 2).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride", [1, 2])
def test_explicit_padding_conv_equals_jax_and_differs_from_same(stride):
    """``conv3x3_i8_reference`` with ResNet-18's ``(1, 1)`` against JAX's ``int8_conv``
    with ``padding=[(1, 1), (1, 1)]``, bit for bit; at 56² stride 2 SAME pads (0, 1),
    another conv."""
    rng = np.random.default_rng(56 + stride)
    x = rng.integers(-127, 128, (1, 56, 56, 32), dtype=np.int8)
    w = rng.integers(-127, 128, (3, 3, 32, 64), dtype=np.int8)
    ws = (rng.random(64) * 1e-4).astype(np.float32)
    want = np.asarray(
        Q.int8_conv(jnp.asarray(x), jnp.asarray(w), np.float32(1.0), jnp.asarray(ws), strides=(stride, stride),
                    padding=[(1, 1), (1, 1)])
    )
    kw = dict(stride=stride, relu=False)
    got = conv3x3_i8_reference(_t(x), pack_conv3x3_i8(_t(w)), _t(ws), torch.zeros(64), padding=[(1, 1), (1, 1)], **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    same = conv3x3_i8_reference(_t(x), pack_conv3x3_i8(_t(w)), _t(ws), torch.zeros(64), padding="SAME", **kw)
    assert same.shape == got.shape
    assert torch.equal(same, got) == (stride == 1)


def test_max_pool_of_codes_equals_jax():
    x = np.random.default_rng(3).integers(-127, 128, (2, 9, 9, 64), dtype=np.int8)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)]))
    got = TQ._max_pool_i8(_t(x))
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_calibrate_resnet18_matches_jax(resnet):
    params, stats, frames, act, _ = resnet
    got = TQ.calibrate_resnet18(params, stats, _t(frames))
    assert got.keys() == act.keys() and {"stem", "layer0_0.in", "layer3_1.mid"} <= got.keys()
    for site, value in act.items():
        assert got[site] == pytest.approx(value, rel=1e-5), site


def test_quantize_resnet18_matches_jax(resnet):
    params, stats, _, act, want = resnet
    got = TQ.quantize_resnet18(params, stats, act)
    for site, value in want["act_scales"].items():
        assert got["act_scales"][site] == float(value), site
    paths = [("stem",)] + [(name, conv) for name in BLOCKS for conv in want[name]]
    assert sum(len(p) == 2 and p[1] == "downsample" for p in paths) == 3
    for path in paths:
        w, g = want, got
        for key in path:
            w, g = w[key], g[key]
        diff = np.abs(g["w_q"].numpy().astype(np.int32) - np.asarray(w["w_q"]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, path
        np.testing.assert_allclose(g["w_scale"].numpy(), np.asarray(w["w_scale"]), rtol=1e-6, err_msg=str(path))
        np.testing.assert_allclose(g["bias"].numpy(), np.asarray(w["bias"]), rtol=1e-6, atol=1e-6, err_msg=str(path))


def test_resnet18_tree_packs_once(resnet):
    *_, act, want = resnet
    t = quantized_tree_from_numpy(want)
    stem = t["stem"]
    assert stem["w_packed"].shape == (64, 192) and stem["w_packed"].dtype == torch.int8
    np.testing.assert_array_equal(stem["w_packed"][:, :147].numpy(), np.asarray(want["stem"]["w_q"]).reshape(147, 64).T)
    assert not stem["w_packed"][:, 147:].any()
    assert stem["x_scale"].item() == float(np.float32(want["act_scales"]["stem"]))
    ds = t["layer2_0"]["downsample"]
    np.testing.assert_array_equal(ds["w_packed"].numpy(), np.asarray(want["layer2_0"]["downsample"]["w_q"]).reshape(128, 256).T)
    assert ds["x_scale"].item() == t["layer2_0"]["conv1"]["x_scale"].item() == t["act_scales"]["layer2_0.in"]
    conv2 = t["layer1_1"]["conv2"]
    np.testing.assert_array_equal(conv2["w_packed"].numpy(), np.asarray(want["layer1_1"]["conv2"]["w_q"]).reshape(9 * 128, 128).T)
    xs = np.float32(want["act_scales"]["layer1_1.mid"])
    np.testing.assert_array_equal(conv2["xs_ws"].numpy(), xs * np.asarray(want["layer1_1"]["conv2"]["w_scale"]))
    assert "downsample" not in t["layer0_0"] and "downsample" not in t["layer3_1"]


@pytest.mark.parametrize("resident", [False, True], ids=["baseline", "resident"])
def test_forwards_match_jax_on_the_same_tree(resnet, resident):
    *_, frames, _, want_tree = resnet
    qt = quantized_tree_from_numpy(want_tree)
    j_fwd = Q.quant_resnet18_forward_resident if resident else Q.quant_resnet18_forward
    t_fwd = TQ.quant_resnet18_forward_resident if resident else TQ.quant_resnet18_forward
    want = np.asarray(j_fwd(want_tree, jnp.asarray(frames)))
    got = t_fwd(qt, _t(frames)).numpy()
    assert got.shape == want.shape == (4, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resident_tracks_baseline_on_the_port_alone():
    """``tests/test_quant.py:217`` on the port alone, on that test's net and frames (the
    flax initialization, N(0, 1) frames of 64²). On the randomized-BatchNorm net above
    both packages drift more than its bound: 0.022 (port) and 0.022 (JAX package)."""
    rng = np.random.default_rng(217)
    frames = rng.normal(0, 1.0, size=(2, 64, 64, 3)).astype(np.float32)
    v = jax.device_get(jax.jit(lambda k, x: ResNet18().init(k, x, train=False))(jax.random.PRNGKey(0), frames))
    params, stats = v["params"], v["batch_stats"]
    q = TQ.quantize_resnet18(params, stats, TQ.calibrate_resnet18(params, stats, _t(frames)))
    base = TQ.quant_resnet18_forward(q, _t(frames)).numpy()
    res = TQ.quant_resnet18_forward_resident(q, _t(frames)).numpy()
    rel = np.abs(res - base).mean() / (np.abs(base).mean() + 1e-8)
    assert rel < 0.02, f"resident drift {rel:.4f}"
    assert np.corrcoef(res.ravel(), base.ravel())[0, 1] > 0.999
