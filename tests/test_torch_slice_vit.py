"""The port's ViT serving forward vs JAX's ``__graft_entry__._build_forward``.

``entry.vit_config``'s model (the flash attention, the tanh GELU) cut to test size:
``videomae_tiny`` (4 blocks, d=192, 3 heads) on 4 frames of 32² (8 tokens), f32, with
the tiny IMU and fusion sizes of ``__graft_entry__._flagship_config(tiny=True)``, batch
2. JAX's parameters before folding go through ``bridge`` into
``tpuhar_torch.entry.build_forward``; both fold (or neither does), both get the same raw
NHWC uint8 clip. Logits, MSP, energy and embeddings agree to 1e-4 abs.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpuhar_torch.entry import build_forward, vit_config  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-4
BATCH = 2


def _config(gelu_from_vit_config: bool = True):
    from __graft_entry__ import _flagship_config

    cfg = _flagship_config(tiny=True)
    serving = vit_config().model
    m = cfg.model
    m.compute_dtype = "float32"
    if gelu_from_vit_config:
        m.gelu_approximate = serving.gelu_approximate
    m.use_flash_attention, m.flash_kernel = serving.use_flash_attention, serving.flash_kernel
    return cfg


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
def test_vit_forward_matches_jax(fold):
    from __graft_entry__ import _build_forward

    cfg = _config()
    jax_fn, (_, video_example) = _build_forward(cfg, BATCH, fold_normalize=fold)
    rng = np.random.default_rng(0)
    imu = rng.normal(0, 8000.0, (BATCH, 250, 6)).astype(np.float32)
    video = rng.integers(0, 256, video_example.shape, dtype=np.uint8)
    assert video.shape == (BATCH, 4, 32, 32, 3)  # NHWC: only tpu_cnn goes patch-major
    want = {k: np.asarray(v) for k, v in jax.jit(jax_fn)(imu, video).items()}

    params = jax.device_get(jax_fn._variables_prefold)
    fn, (imu_example, video_arg) = build_forward(cfg, BATCH, device="cpu", params=params, fold_normalize=fold)
    assert tuple(video_arg.shape) == video.shape and video_arg.dtype == torch.uint8
    assert tuple(imu_example.shape) == imu.shape
    got = fn(torch.from_numpy(imu), torch.from_numpy(video))
    assert set(got) == set(want) == {"logits", "msp", "energy", "embeddings"}
    for key, value in want.items():
        assert tuple(got[key].shape) == value.shape and got[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].numpy(), value, atol=ATOL, rtol=0, err_msg=key)


def test_vit_forward_serves_the_tanh_gelu_at_the_default_flag():
    """``gelu_approximate`` left at its default (False) on both sides: the reference
    serves every ViT backbone with the tanh GELU, on a copy of the config, and so must
    ``build_forward``; the caller's config is left as it was."""
    from __graft_entry__ import _build_forward

    cfg = _config(gelu_from_vit_config=False)
    assert cfg.model.gelu_approximate is False
    jax_fn, (_, video_example) = _build_forward(cfg, BATCH)
    rng = np.random.default_rng(1)
    imu = rng.normal(0, 8000.0, (BATCH, 250, 6)).astype(np.float32)
    video = rng.integers(0, 256, video_example.shape, dtype=np.uint8)
    want = {k: np.asarray(v) for k, v in jax.jit(jax_fn)(imu, video).items()}
    fn, _ = build_forward(cfg, BATCH, device="cpu", params=jax.device_get(jax_fn._variables_prefold))
    got = fn(torch.from_numpy(imu), torch.from_numpy(video))
    assert cfg.model.gelu_approximate is False
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value, atol=ATOL, rtol=0, err_msg=key)
