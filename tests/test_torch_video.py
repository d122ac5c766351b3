"""Port video tower, normalization fold and patch-major layout vs the JAX package.

``TPUVideoCNN`` runs on 64×64 frames against JAX's ``conv_backend="pallas"`` form
(its residual convs through the Pallas kernel in interpret mode), f32, at atol 2e-3,
the tolerance of ``tests/test_conv3x3.py::test_tpucnn_backend_equivalence``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.config import Config
from tpuhar.models.video import TPUVideoCNN as JaxTPUVideoCNN
from tpuhar.ops.fold import fold_normalization as jax_fold_normalization
from tpuhar.ops.stem import pack_stem_weights as jax_pack_stem_weights
from tpuhar.ops.stem import to_patch_major as jax_to_patch_major
from tpuhar_torch.bridge import load_variables
from tpuhar_torch.models.video import TPUVideoCNN, VideoEncoder
from tpuhar_torch.ops.fold import fold_normalization
from tpuhar_torch.ops.stem import pack_stem_weights, to_patch_major
from tpuhar_torch.ops.video import normalize_clip, prepare_clip

torch.set_num_threads(2)

ATOL = 2e-3


def _perturbed(variables, seed):
    """Move BN stats and scales off their identity init so folding is exercised."""
    rng = np.random.default_rng(seed)
    variables = jax.device_get(variables)
    params = jax.tree.map(
        lambda v: np.asarray(v) * (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        + 0.05 * rng.standard_normal(v.shape).astype(np.float32),
        variables["params"],
    )
    stats = jax.tree.map(
        lambda v: np.asarray(v) + 0.25 * rng.random(v.shape).astype(np.float32),
        variables["batch_stats"],
    )
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def tower():
    """JAX's Pallas-form tower with perturbed variables, at 4 frames of 64×64."""
    net = JaxTPUVideoCNN(conv_backend="pallas", dtype=jnp.float32)
    frames = np.random.default_rng(0).standard_normal((4, 64, 64, 3)).astype(np.float32)
    variables = net.init(jax.random.PRNGKey(0), frames[:1, :32, :32], train=False)
    return net, _perturbed(variables, 1), frames


@pytest.mark.parametrize("layout", ["nhwc", "patch_major"])
def test_tpu_video_cnn_matches_pallas_form(tower, layout):
    net, variables, frames = tower
    if layout == "patch_major":
        frames = np.asarray(jax_to_patch_major(frames))
        assert frames.shape == (4, 4, 4, 768)
    want = np.asarray(net.apply(variables, frames, train=False))
    model = load_variables(TPUVideoCNN(), variables)
    got = model(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (4, 512)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_tpu_cnn_large_matches_pallas_form():
    """``tpu_cnn_large``: widths (384, 512), two residual blocks per stage."""
    from tpuhar_torch.models.video import TPU_CNN_CONFIGS

    widths, blocks = TPU_CNN_CONFIGS["tpu_cnn_large"]
    net = JaxTPUVideoCNN(widths=widths, blocks_per_stage=blocks, conv_backend="pallas", dtype=jnp.float32)
    frames = np.random.default_rng(7).standard_normal((4, 64, 64, 3)).astype(np.float32)
    variables = _perturbed(net.init(jax.random.PRNGKey(1), frames[:1, :32, :32], train=False), 8)
    want = np.asarray(net.apply(variables, frames, train=False))
    model = load_variables(TPUVideoCNN(widths, blocks), variables)
    with torch.inference_mode():
        got = model(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _encoder_variables(tower):
    _, variables, _ = tower
    rng = np.random.default_rng(2)
    proj = {
        "kernel": (rng.standard_normal((512, 64)) * 0.05).astype(np.float32),
        "bias": (rng.standard_normal(64) * 0.1).astype(np.float32),
    }
    return {
        "params": {"video_encoder": {"backbone": variables["params"], "projection": proj}},
        "batch_stats": {"video_encoder": {"backbone": variables["batch_stats"]}},
    }


def test_fold_normalization_matches_jax(tower):
    cfg = Config()
    cfg.model.video_backbone = "tpu_cnn"
    variables = _encoder_variables(tower)
    before = copy.deepcopy(variables)
    got, changed = fold_normalization(variables, cfg)
    want, want_changed = jax_fold_normalization(variables, cfg)
    assert changed and want_changed
    jax.tree.map(np.testing.assert_array_equal, variables, before)  # input untouched
    g = jax.tree.map(np.asarray, got)
    w = jax.tree.map(np.asarray, jax.device_get(want))
    assert jax.tree.structure(g) == jax.tree.structure(w)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5), g, w)

    cfg.model.video_backbone = "resnet18"  # a padded stem: no exact fold
    assert fold_normalization(variables, cfg) == (variables, False)


def test_folded_encoder_matches_unfolded(tower):
    """Raw pixels through the folded stem == normalized pixels through the original
    one, in f32 (the BN mean shift is large, so bf16 would not show this)."""
    cfg = Config()
    cfg.model.video_backbone = "tpu_cnn"
    variables = _encoder_variables(tower)
    folded, changed = fold_normalization(variables, cfg)
    assert changed
    clip = np.random.default_rng(3).integers(0, 256, (1, 4, 64, 64, 3), dtype=np.uint8)
    enc = load_variables(VideoEncoder("tpu_cnn", 64), {
        k: v["video_encoder"] for k, v in variables.items()
    })
    enc_folded = load_variables(VideoEncoder("tpu_cnn", 64), {
        k: v["video_encoder"] for k, v in folded.items()
    })
    with torch.inference_mode():
        emb, tokens = enc(prepare_clip(torch.from_numpy(clip)))
        emb_f, tokens_f = enc_folded(torch.from_numpy(to_patch_major(clip)).float())
    assert emb.dtype == torch.float32 and tokens.shape == (1, 4, 64)
    np.testing.assert_allclose(tokens_f.numpy(), tokens.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(emb_f.numpy(), emb.numpy(), atol=ATOL, rtol=0)


def test_normalize_clip_matches_jax():
    from tpuhar.ops.video import normalize_clip as jax_normalize_clip

    clip = np.random.default_rng(4).integers(0, 256, (2, 3, 8, 8, 3), dtype=np.uint8)
    got = normalize_clip(torch.from_numpy(clip)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_normalize_clip(clip)), atol=1e-6, rtol=0)


def test_patch_major_layout_is_byte_equal():
    frames = np.random.default_rng(5).integers(0, 256, (2, 3, 32, 48, 3), dtype=np.uint8)
    got = to_patch_major(frames)
    want = jax_to_patch_major(frames)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (2, 3, 2, 3, 768)
    assert got.tobytes() == want.tobytes()
    kernel = np.random.default_rng(6).standard_normal((16, 16, 3, 8)).astype(np.float32)
    np.testing.assert_array_equal(pack_stem_weights(kernel), np.asarray(jax_pack_stem_weights(kernel)))
    with pytest.raises(ValueError):
        to_patch_major(frames[..., :30, :, :])
