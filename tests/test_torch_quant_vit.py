"""The port's int8 ViT PTQ (``tpuhar_torch/ops/quant_vit.py``) vs the JAX package's
``tpuhar/ops/quant_vit.py``, on the same numpy inputs.

Two ViTs: the JAX tests' tiny one (depth 2, d 64, 2 heads: Dh = 32, where ``1/sqrt(Dh)``
rounds in bf16) and ``videomae_tiny``'s widths (depth 4, d 192, 3 heads: Dh = 64, where
it is exact), on 2 clips of 2 frames of 32² (4 tokens).

Tolerances, with their reasons:
- ``_patchify``: a permutation, equal bit for bit;
- ``vit_forward_f32``: rtol 2e-4 / atol 2e-5, the bound the JAX package holds its own
  mirror to against flax (f32 products in another sum order; 3.1e-6 and 3.8e-6 of
  tokens up to 3.3 measured);
- ``calibrate_vit``: the same sums, site absmax to 1e-5 relative (4.4e-7 and 7.5e-7
  measured);
- ``quantize_vit`` on JAX's statistics: ``w_q`` and ``w_scale`` equal bit for bit (the
  same elementwise f32 ops); biases to 1e-6 (the fold's tap sum runs in another order;
  1.2e-7 measured);
- ``quant_vit_forward`` on JAX's own tree carried over (``quantized_tree_from_numpy``):
  every int8 product is exact in both, the LayerNorms, GELU and attention products are
  f32 or bf16 sums in another order. Measured at most 4.8e-7 in f32 and in bf16, of
  tokens up to 3.8, at both widths, folded or not; held to atol 2e-5 in f32 and 1e-4 in
  bf16 (a value whose rounding to bf16 sits on a tie may move by one bf16 ulp, 2^-8
  relative, before the final norm);
- the JAX package's own floors on the port alone (``tests/test_quant_vit.py``): int8
  against f32 tokens mean drift < 0.15 and correlation > 0.98; bf16 against f32
  attention and stream correlation > 0.99.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.models.video import VideoViT
from tpuhar.ops import quant_vit as JQ
from tpuhar.ops.video import IMAGENET_MEAN, IMAGENET_STD
from tpuhar_torch.bridge import quantized_tree_from_numpy
from tpuhar_torch.ops import quant_vit as TQ

torch.set_num_threads(2)

VITS = {"dh32": (2, 64, 2), "dh64": (4, 192, 3)}  # (depth, d_model, heads)
FOLD = (IMAGENET_MEAN, IMAGENET_STD)
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-4)}


@pytest.fixture(scope="module", params=list(VITS))
def vit(request):
    depth, d_model, heads = VITS[request.param]
    rng = np.random.default_rng(depth)
    clip = rng.normal(0, 1.0, (2, 2, 32, 32, 3)).astype(np.float32)
    net = VideoViT(depth=depth, d_model=d_model, num_heads=heads)
    variables = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(clip)))
    clip_u8 = rng.integers(0, 256, (2, 2, 32, 32, 3), dtype=np.uint8)
    clip_u8[0, 0, :16, :16] = 0  # pure-black pixels: the clip corner of the u8 map
    return net, variables, clip, clip_u8


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("tubelet", [(2, 16, 16), (1, 8, 4)])
def test_patchify_equals_jax(dtype, tubelet):
    x = np.random.default_rng(0).integers(0, 256, (2, 4, 32, 16, 3)).astype(dtype)
    want = np.asarray(JQ._patchify(jnp.asarray(x), *tubelet))
    got = TQ._patchify(torch.from_numpy(x), *tubelet).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_vit_layout_matches_jax(vit):
    _, variables, _, _ = vit
    assert TQ._vit_layout(variables["params"]) == JQ._vit_layout(variables["params"])


def test_vit_forward_f32_matches_jax(vit):
    _, variables, clip, _ = vit
    want = np.asarray(JQ.vit_forward_f32(variables["params"], jnp.asarray(clip)))
    got = TQ.vit_forward_f32(variables["params"], torch.from_numpy(clip)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_calibrate_vit_matches_jax(vit):
    _, variables, clip, _ = vit
    want = JQ.calibrate_vit(variables["params"], {}, clip)
    got = TQ.calibrate_vit(variables["params"], {}, torch.from_numpy(clip))
    assert got.keys() == want.keys() and {"tubelet", "block1.mlp_mid", "block0.attn_out_in"} <= got.keys()
    for site, value in want.items():
        assert got[site] == pytest.approx(value, rel=1e-5), site


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "input_fold"])
def test_quantize_vit_matches_jax(vit, fold):
    _, variables, clip, _ = vit
    params = variables["params"]
    stats = JQ.calibrate_vit(params, {}, clip)
    want = jax.device_get(JQ.quantize_vit(params, {}, stats, input_fold=FOLD if fold else None))
    got = TQ.quantize_vit(params, {}, stats, input_fold=FOLD if fold else None)
    for key in ("depth", "heads", "head_dim", "input_fold"):
        assert got[key] == want[key], key
    assert got["tubelet"] == tuple(want["tubelet"]) == (2, 16, 16)
    for site, value in want["act_scales"].items():
        assert got["act_scales"][site] == float(value), site
    layers = [("stem",)] + [(f"block{i}", n) for i in range(want["depth"]) for n in ("qkv", "out", "mlp_in", "mlp_out")]
    for path in layers:
        w, g = want, got
        for key in path:
            w, g = w[key], g[key]
        np.testing.assert_array_equal(g["w_q"].numpy(), np.asarray(w["w_q"]), err_msg=str(path))
        np.testing.assert_array_equal(g["w_scale"].numpy(), np.asarray(w["w_scale"]), err_msg=str(path))
        np.testing.assert_allclose(g["bias"].numpy(), np.asarray(w["bias"]), rtol=1e-6, atol=1e-6, err_msg=str(path))
        np.testing.assert_array_equal(g["w_packed"].numpy(), np.asarray(w["w_q"]).T)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    np.testing.assert_array_equal(got["final_norm"]["scale"].numpy(), np.asarray(want["final_norm"]["scale"]))
    qkv = got["block0"]["qkv"]
    assert qkv["w_packed"].shape == (3 * got["heads"] * got["head_dim"], params["tubelet"]["proj"]["kernel"].shape[-1])
    assert qkv["x_scale"].item() == got["act_scales"]["block0.qkv_in"]
    np.testing.assert_array_equal(qkv["xs_ws"].numpy(), np.float32(qkv["x_scale"].item()) * qkv["w_scale"].numpy())
    stem = got["stem"]
    np.testing.assert_array_equal(stem["xs_ws"].numpy(), stem["w_scale"].numpy() * (1.0 if fold else np.float32(stats["tubelet"] / 127.0)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fold", [False, True], ids=["plain", "input_fold"])
def test_quant_vit_forward_matches_jax_on_the_same_tree(vit, fold, dtype):
    """JAX's tree through both packages: normalized f32 clips without the fold, raw
    uint8 with it; attention and stream in f32 and in bf16."""
    _, variables, clip, clip_u8 = vit
    params = variables["params"]
    stats = JQ.calibrate_vit(params, {}, clip)
    qj = jax.device_get(JQ.quantize_vit(params, {}, stats, input_fold=FOLD if fold else None))
    qt = quantized_tree_from_numpy(qj)
    x = clip_u8 if fold else clip
    jdt, tdt, atol = DTYPES[dtype]
    want = np.asarray(JQ.quant_vit_forward(qj, jnp.asarray(x), attn_dtype=jdt, stream_dtype=jdt))
    got = TQ.quant_vit_forward(qt, torch.from_numpy(x), attn_dtype=tdt, stream_dtype=tdt).numpy()
    assert got.shape == want.shape == (2, 4, params["tubelet"]["proj"]["kernel"].shape[-1])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_the_port_meets_the_jax_floors(vit):
    """``tests/test_quant_vit.py``'s bounds, on the port alone: its own calibration,
    quantization and forwards against its own f32 mirror."""
    _, variables, clip, _ = vit
    params = variables["params"]
    x = torch.from_numpy(clip)
    f32 = TQ.vit_forward_f32(params, x).numpy()
    q = TQ.quantize_vit(params, {}, TQ.calibrate_vit(params, {}, x))
    t32 = TQ.quant_vit_forward(q, x, attn_dtype=torch.float32, stream_dtype=torch.float32).numpy()
    rel = np.abs(t32 - f32).mean() / (np.abs(f32).mean() + 1e-8)
    assert rel < 0.15, f"quantization drift {rel:.3f}"
    assert np.corrcoef(t32.ravel(), f32.ravel())[0, 1] > 0.98
    t16 = TQ.quant_vit_forward(q, x).numpy()
    assert np.corrcoef(t16.ravel(), t32.ravel())[0, 1] > 0.99


def test_input_fold_tree_refuses_float_clips(vit):
    _, variables, clip, _ = vit
    params = variables["params"]
    q = TQ.quantize_vit(params, {}, TQ.calibrate_vit(params, {}, torch.from_numpy(clip)), input_fold=FOLD)
    with pytest.raises(TypeError, match="raw uint8"):
        TQ.quant_vit_forward(q, torch.from_numpy(clip))
