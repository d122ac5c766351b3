"""The port's int8 PTQ of the ``tpu_cnn`` tower (``tpuhar_torch/ops/quant.py``) vs the
JAX package's ``tpuhar/ops/quant.py``, on the same numpy inputs.

- the primitives (``quantize_weights``, ``quantize_activations``, ``int8_conv``,
  ``fold_bn``) agree bit for bit; rounding is half to even in both;
- ``calibrate_tpucnn`` agrees to rtol 1e-5 (f32 convs, sums in another order);
- ``quantize_tpucnn`` on the same statistics: ``w_q`` equal, or off by one on at most
  0.1% of entries (a weight at a rounding tie after a fold whose sums ran in another
  order), scales to rtol 1e-6;
- both forwards on JAX's own quantized tree, carried over by
  ``bridge.quantized_tree_from_numpy``: every int8 code is equal (the integer
  accumulators are exact in both), so the features agree to the f32 sum order of the
  pooled mean, rtol 1e-6 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.ops import quant as Q
from tpuhar.ops.stem import to_patch_major
from tpuhar.ops.video import IMAGENET_MEAN, IMAGENET_STD, normalize_clip
from tpuhar_torch.bridge import quantized_tree_from_numpy
from tpuhar_torch.ops import quant as TQ

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_round_is_half_to_even_in_both():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, -127.5], np.float32)
    want = np.array([0, 2, 2, 0, -2, -2, 126, 127, -127], np.int8)
    np.testing.assert_array_equal(np.asarray(Q.quantize_activations(jnp.asarray(x), jnp.float32(1.0))), want)
    np.testing.assert_array_equal(TQ.quantize_activations(_t(x), 1.0).numpy(), want)
    # and at a scale where x / scale lands on the ties exactly
    np.testing.assert_array_equal(TQ.quantize_activations(_t(x * 0.25), 0.25).numpy(), want)


@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (16, 16, 3, 24)])
def test_quantize_weights_matches_jax(shape):
    w = np.random.default_rng(0).normal(0, 0.05, shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-8 floor
    w_q, scale = Q.quantize_weights(jnp.asarray(w), axis=-1)
    t_q, t_scale = TQ.quantize_weights(_t(w), axis=-1)
    np.testing.assert_array_equal(t_q.numpy(), np.asarray(w_q))
    np.testing.assert_array_equal(t_scale.numpy(), np.asarray(scale))


def test_quantize_activations_matches_jax():
    x = np.random.default_rng(1).normal(0, 3, (4, 7, 7, 32)).astype(np.float32)
    for scale in (0.07, 0.0123457, 1 / 127.0):
        want = np.asarray(Q.quantize_activations(jnp.asarray(x), jnp.float32(scale)))
        np.testing.assert_array_equal(TQ.quantize_activations(_t(x), float(np.float32(scale))).numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [4, 7])
def test_int8_conv_matches_jax(stride, size):
    rng = np.random.default_rng(size * 10 + stride)
    x = rng.integers(-127, 128, (2, size, size, 32), dtype=np.int8)
    w = rng.integers(-127, 128, (3, 3, 32, 48), dtype=np.int8)
    ws = (rng.random(48) * 1e-3).astype(np.float32)
    xs = np.float32(0.0173)
    want = np.asarray(
        Q.int8_conv(jnp.asarray(x), jnp.asarray(w), xs, jnp.asarray(ws), strides=(stride, stride), padding="SAME")
    )
    got = TQ.int8_conv(_t(x), _t(w), torch.tensor(xs), _t(ws), stride=stride, padding="SAME").numpy()
    assert got.shape == want.shape == (2, -(-size // stride), -(-size // stride), 48)
    np.testing.assert_array_equal(got, want)


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(2)
    kernel = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    scale, bias, mean = (rng.normal(size=16).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    k, b = Q.fold_bn(jnp.asarray(kernel), scale, bias, mean, var)
    tk, tb = TQ.fold_bn(_t(kernel), _t(scale), _t(bias), _t(mean), _t(var))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(b))


def _net(widths, patch, blocks, frames, seed=0):
    """A flax TPUVideoCNN's variables with random BatchNorm parameters and statistics."""
    from tpuhar.models.video import TPUVideoCNN

    net = TPUVideoCNN(widths=widths, patch=patch, blocks_per_stage=blocks, dtype=jnp.float32)
    v = jax.device_get(jax.jit(lambda k, x: net.init(k, x, train=False))(jax.random.PRNGKey(seed), frames))
    rng = np.random.default_rng(seed)
    params = {k: dict(v) for k, v in v["params"].items()}
    stats = {k: dict(v) for k, v in v["batch_stats"].items()}
    for name in params:
        if name.endswith("_bn"):
            n = params[name]["scale"].shape[0]
            params[name] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                            "bias": rng.normal(0, 0.1, n).astype(np.float32)}
            stats[name] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                           "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    return params, stats


def _frames(seed=0):
    u8 = (np.random.default_rng(seed).random((4, 64, 64, 3)) * 255).astype(np.uint8)
    u8[0, :16, :16] = 0
    return u8, np.array(normalize_clip(jnp.asarray(u8)[None])[0])


def test_calibrate_tpucnn_matches_jax():
    u8, norm = _frames()
    params, stats = _net((32, 64), 8, 2, norm)
    want = Q.calibrate_tpucnn(params, stats, norm)
    got = TQ.calibrate_tpucnn(params, stats, _t(norm))
    assert got.keys() == want.keys()
    assert {"stem", "s0b1.mid", "down1.in", "s1b1.in"} <= got.keys()
    for site, value in want.items():
        assert got[site] == pytest.approx(value, rel=1e-5), site


@pytest.mark.parametrize("input_fold", [False, True])
def test_quantize_tpucnn_matches_jax(input_fold):
    u8, norm = _frames()
    params, stats = _net((32, 64), 8, 1, norm)
    act = Q.calibrate_tpucnn(params, stats, norm)
    fold = (IMAGENET_MEAN, IMAGENET_STD) if input_fold else None
    want = jax.device_get(Q.quantize_tpucnn(params, stats, act, input_fold=fold))
    got = TQ.quantize_tpucnn(params, stats, act, input_fold=fold)
    assert got["layout"] == tuple(want["layout"]) == (2, 1)
    assert got["patch"] == want["patch"] and got["input_fold"] == want["input_fold"] == input_fold
    for site, value in want["act_scales"].items():
        assert got["act_scales"][site] == float(value), site
    for path in (("stem",), ("down1",), ("s0b0", "a"), ("s0b0", "b"), ("s1b0", "a"), ("s1b0", "b")):
        w, g = want, got
        for key in path:
            w, g = w[key], g[key]
        diff = np.abs(g["w_q"].numpy().astype(np.int32) - np.asarray(w["w_q"]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, path
        np.testing.assert_allclose(g["w_scale"].numpy(), np.asarray(w["w_scale"]), rtol=1e-6, err_msg=str(path))
        np.testing.assert_allclose(g["bias"].numpy(), np.asarray(w["bias"]), rtol=1e-6, atol=1e-6, err_msg=str(path))


def test_quantized_tree_from_numpy_packs_once():
    u8, norm = _frames()
    params, stats = _net((32, 64), 8, 1, norm)
    q = jax.device_get(Q.quantize_tpucnn(params, stats, Q.calibrate_tpucnn(params, stats, norm)))
    t = quantized_tree_from_numpy(q)
    assert t["stem"]["w_packed"].shape == (32, 8 * 8 * 3) and t["stem"]["w_packed"].dtype == torch.int8
    np.testing.assert_array_equal(t["stem"]["w_packed"].numpy(), np.asarray(q["stem"]["w_q"]).reshape(8 * 8 * 3, 32).T)
    conv = t["s1b0"]["b"]
    np.testing.assert_array_equal(conv["w_packed"].numpy(), np.asarray(q["s1b0"]["b"]["w_q"]).reshape(9 * 64, 64).T)
    xs = np.float32(q["act_scales"]["s1b0.mid"])
    assert conv["x_scale"].item() == float(xs) == t["act_scales"]["s1b0.mid"]
    np.testing.assert_array_equal(conv["xs_ws"].numpy(), xs * np.asarray(q["s1b0"]["b"]["w_scale"]))
    assert t["down1"]["x_scale"].item() == float(np.float32(q["act_scales"]["down1.in"]))


@pytest.mark.parametrize(
    "widths,patch,blocks",
    [((32, 64), 8, 1), ((32, 64), 8, 2), ((256, 512), 16, 1)],
    ids=["w32-64-b1", "w32-64-b2", "flagship"],
)
@pytest.mark.parametrize("resident", [False, True], ids=["baseline", "resident"])
def test_forwards_match_jax_on_the_same_tree(widths, patch, blocks, resident):
    """JAX's tree through both packages, for each input the JAX forwards take: the
    uint8 patch-major wire and NHWC uint8 (``input_fold``), NHWC f32 (without)."""
    u8, norm = _frames(seed=blocks)
    params, stats = _net(widths, patch, blocks, norm, seed=blocks)
    act = Q.calibrate_tpucnn(params, stats, norm)
    j_fwd = Q.quant_tpucnn_forward_resident if resident else Q.quant_tpucnn_forward
    t_fwd = TQ.quant_tpucnn_forward_resident if resident else TQ.quant_tpucnn_forward
    for fold, inputs in (
        (True, (to_patch_major(u8, patch), u8)),
        (False, (norm,)),
    ):
        qj = jax.device_get(
            Q.quantize_tpucnn(params, stats, act, input_fold=(IMAGENET_MEAN, IMAGENET_STD) if fold else None)
        )
        qt = quantized_tree_from_numpy(qj)
        for x in inputs:
            want = np.asarray(j_fwd(qj, jnp.asarray(x)))
            got = t_fwd(qt, _t(x)).numpy()
            assert got.shape == want.shape == (4, widths[-1]) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"fold={fold} {x.shape}")


def test_resident_int8_codes_equal_jax_between_convs():
    """The int8 stem codes of the resident path, from JAX's fused requant and from the
    port's, are equal element for element."""
    u8, norm = _frames(seed=3)
    params, stats = _net((256, 512), 16, 1, norm, seed=3)
    act = Q.calibrate_tpucnn(params, stats, norm)
    qj = jax.device_get(Q.quantize_tpucnn(params, stats, act, input_fold=(IMAGENET_MEAN, IMAGENET_STD)))
    qt = quantized_tree_from_numpy(qj)
    col = to_patch_major(u8, 16)
    scale = qj["act_scales"]["s0b0.in"]
    want = np.asarray(Q._stem_patch_major(qj, jnp.asarray(col), out_scale=scale, out_dtype=jnp.int8))
    got = TQ._stem_patch_major(qt, _t(col), out_scale=qt["act_scales"]["s0b0.in"]).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_nhwc_frames_refused_on_a_cuda_tensor(monkeypatch):
    """Without a card, a tensor that claims to be on CUDA stands in for one: the stem
    refuses NHWC frames there instead of taking the plain conv."""
    u8, norm = _frames()
    params, stats = _net((32, 64), 8, 1, norm)
    q = TQ.quantize_tpucnn(params, stats, TQ.calibrate_tpucnn(params, stats, _t(norm)), input_fold=(IMAGENET_MEAN, IMAGENET_STD))

    class FakeCuda:
        class device:
            type = "cuda"

        shape = (4, 64, 64, 3)

        def dim(self):
            return 4

    with pytest.raises(ValueError, match="patch-major wire only"):
        TQ._stem_nhwc(q, FakeCuda())
