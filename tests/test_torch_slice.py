"""The port's flagship serving forward vs JAX's ``__graft_entry__._build_forward``.

The flagship configuration cut to test size (f32, ``conv_backend="pallas"``, IMU
d=64 / 4 heads / 2 layers, fusion 4 heads, 8 classes, ``tpu_cnn`` at full width,
4 frames of 64², batch 2). JAX's parameters before folding
(``forward._variables_prefold``) go through ``bridge`` into
``tpuhar_torch.entry.build_forward``; both fold, both get the same raw inputs.
Logits, MSP, energy and embeddings agree to 1e-4 abs.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpuhar_torch.bridge import _flatten, init_params  # noqa: E402
from tpuhar_torch.entry import build_forward  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-4
BATCH = 2


def _config():
    from __graft_entry__ import _flagship_config

    cfg = _flagship_config()
    m = cfg.model
    m.compute_dtype = "float32"
    m.conv_backend = "pallas"
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 64, 4, 2
    m.fusion_heads = 4
    m.num_classes = 8
    cfg.data.video_resize = (64, 64)
    cfg.data.video_frames_per_window = 4
    return cfg


@pytest.fixture(scope="module", params=[True, False], ids=["folded", "unfolded"])
def jax_forward(request):
    from __graft_entry__ import _build_forward

    cfg = _config()
    fn, (imu_example, video_example) = _build_forward(cfg, BATCH, fold_normalize=request.param)
    return cfg, request.param, fn, video_example.shape


def _inputs(video_shape, seed=0):
    from tpuhar.ops.stem import to_patch_major

    rng = np.random.default_rng(seed)
    imu = rng.normal(0, 8000.0, (BATCH, 250, 6)).astype(np.float32)
    clip = rng.integers(0, 256, (BATCH, 4, 64, 64, 3), dtype=np.uint8)
    video = to_patch_major(clip) if video_shape[-1] == 768 else clip
    assert video.shape == video_shape
    return imu, video


def test_forward_matches_jax(jax_forward):
    cfg, fold, jax_fn, video_shape = jax_forward
    imu, video = _inputs(video_shape)
    want = {k: np.asarray(v) for k, v in jax.jit(jax_fn)(imu, video).items()}

    params = jax.device_get(jax_fn._variables_prefold)
    fn, (imu_example, video_example) = build_forward(
        cfg, BATCH, device="cpu", params=params, fold_normalize=fold
    )
    assert tuple(video_example.shape) == video_shape and video_example.dtype == torch.uint8
    assert tuple(imu_example.shape) == (BATCH, 250, 6)
    got = fn(torch.from_numpy(imu), torch.from_numpy(video))
    assert set(got) == set(want) == {"logits", "msp", "energy", "embeddings"}
    for key, value in want.items():
        assert tuple(got[key].shape) == value.shape, key
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].numpy(), value, atol=ATOL, rtol=0, err_msg=key)


def test_init_params_has_flax_tree_and_distributions(jax_forward):
    """``init_params`` draws the tree JAX's flax init makes: the same leaves, the
    same sizes, flax's initialiser for each, and the same draw from the same seed."""
    cfg, _, jax_fn, _ = jax_forward
    flax_leaves = dict(_flatten(jax.device_get(jax_fn._variables_prefold)))
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    leaves = dict(_flatten(ours))
    assert leaves.keys() == flax_leaves.keys()
    for key, value in leaves.items():
        assert value.dtype == np.float32 and value.size == flax_leaves[key].size, key
    assert all(np.all(leaves[k] == 1.0) for k in leaves if k[-1] in ("scale", "var"))
    assert all(np.all(leaves[k] == 0.0) for k in leaves if k[-1] in ("bias", "mean"))
    kernel = leaves[("params", "video_encoder", "backbone", "s1b0a_conv", "kernel")]
    fan_in = 3 * 3 * 512
    assert abs(kernel.std() * np.sqrt(fan_in) - 1.0) < 0.01  # lecun: var = 1/fan_in
    assert np.abs(kernel).max() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in)  # ±2σ
    pos = leaves[("params", "imu_encoder", "pos_encoding")]
    assert abs(pos.std() - 1.0) < 0.05
    again = dict(_flatten(init_params(cfg, torch.Generator().manual_seed(0))))
    assert all(np.array_equal(again[k], v) for k, v in leaves.items())
