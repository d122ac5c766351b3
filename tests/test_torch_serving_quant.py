"""The port's quantized serving forward (``tpuhar_torch/serving_quant.py``) vs the JAX
package's ``tpuhar/serving_quant.py``.

The flagship configuration cut to test size (f32, ``tpu_cnn`` at full width, IMU d=64 /
4 heads / 2 layers, fusion 4 heads, 8 classes, 4 frames of 64², batch 2), the same
flax variables, calibration clips and IMU input in both. The port gets the clip as the
uint8 patch-major wire; JAX scores its calibration clips NHWC (``tests/test_stem.py``
pins the two layouts as equal).

Tolerances, with their reasons:
- same calibration statistics (JAX's, handed to the port): every int8 code equal, so
  the logits, MSP, energy, embeddings and the recalibration map ``(a, b)`` agree to
  f32 sum order, 1e-5 abs;
- each package calibrating itself: the absmax walks are f32 convs with sums in another
  order, so a site scale may differ in its last bit and flip an int8 code by one step
  here and there; outputs and ``(a, b)`` within 2e-3 abs (about 0.1% of their
  magnitude; 1.2e-4 was measured on the embeddings, 2.1e-5 on the logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.ops.stem import to_patch_major
from tpuhar.serving_quant import build_quantized_forward as jax_build
from tpuhar.serving_quant import fit_logit_recalibration as jax_fit
from tpuhar_torch import serving_quant as TS

torch.set_num_threads(2)

BATCH, FRAMES, SIZE, NCAL = 2, 4, 64, 6
TIGHT = 1e-5
LOOSE = 2e-3


def _config():
    from __graft_entry__ import _flagship_config

    cfg = _flagship_config()
    m = cfg.model
    m.compute_dtype = "float32"
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 64, 4, 2
    m.fusion_heads = 4
    m.num_classes = 8
    cfg.data.video_resize = (SIZE, SIZE)
    cfg.data.video_frames_per_window = FRAMES
    return cfg


@pytest.fixture(scope="module")
def setup():
    from tpuhar.models.crossmodal import FusionClassifier

    cfg = _config()
    variables = jax.device_get(
        jax.jit(FusionClassifier(cfg).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 6, 250)), jnp.zeros((1, FRAMES, SIZE, SIZE, 3))
        )
    )
    rng = np.random.default_rng(1)
    calib = (rng.random((NCAL, FRAMES, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    calib_imu = rng.normal(0, 8000, (NCAL, 250, 6)).astype(np.float32)
    imu = rng.normal(0, 8000, (BATCH, 250, 6)).astype(np.float32)
    clip = rng.integers(0, 256, (BATCH, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
    return cfg, variables, calib, calib_imu, imu, clip


@pytest.fixture(scope="module", params=[True, False], ids=["resident", "baseline"])
def jax_run(request, setup):
    cfg, variables, calib, calib_imu, imu, clip = setup
    fn = jax_build(cfg, variables, calib, calib_imu_raw=calib_imu, resident=request.param)
    out = {k: np.asarray(v) for k, v in jax.jit(fn)(imu, clip).items()}
    return request.param, fn.recalibration, out


def _port(setup, resident):
    cfg, variables, calib, calib_imu, imu, clip = setup
    fn = TS.build_quantized_forward(
        cfg, variables, calib, device="cpu", calib_imu_raw=calib_imu, resident=resident
    )
    out = fn(torch.from_numpy(imu), torch.from_numpy(to_patch_major(clip)))
    return fn, {k: v.numpy() for k, v in out.items()}


def _compare(fn, out, recal, want, atol):
    assert set(out) == set(want) == {"logits", "msp", "energy", "embeddings"}
    for key, value in want.items():
        assert out[key].shape == value.shape and out[key].dtype == np.float32, key
        np.testing.assert_allclose(out[key], value, rtol=0, atol=atol, err_msg=key)
    for got, ref in zip(fn.recalibration, recal):
        assert got.shape == ref.shape == (8,)
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_build_quantized_forward_matches_jax_on_the_same_calibration(setup, jax_run, monkeypatch):
    from tpuhar.ops.quant import calibrate_tpucnn as jax_calibrate

    resident, recal, want = jax_run
    monkeypatch.setattr(
        TS, "calibrate_tpucnn", lambda params, stats, frames: jax_calibrate(params, stats, frames.numpy())
    )
    fn, out = _port(setup, resident)
    _compare(fn, out, recal, want, TIGHT)


def test_build_quantized_forward_matches_jax(setup, jax_run):
    resident, recal, want = jax_run
    fn, out = _port(setup, resident)
    _compare(fn, out, recal, want, LOOSE)
    q = fn.quantized_tree
    assert q["layout"] == (2, 1) and q["input_fold"] and q["patch"] == 16
    assert q["s1b0"]["b"]["w_packed"].shape == (512, 9 * 512)


def test_recalibration_off_and_affine(setup):
    cfg, variables, calib, calib_imu, imu, clip = setup
    on = TS.build_quantized_forward(cfg, variables, calib, device="cpu", calib_imu_raw=calib_imu)
    off = TS.build_quantized_forward(cfg, variables, calib, device="cpu", recalibrate=False)
    assert off.recalibration is None
    args = torch.from_numpy(imu), torch.from_numpy(to_patch_major(clip))
    a, b = on.recalibration
    np.testing.assert_allclose(on(*args)["logits"].numpy(), a * off(*args)["logits"].numpy() + b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backbone,item", [("resnet18", "4"), ("videomae_base", "4")])
def test_other_backbones_are_not_ported(setup, backbone, item):
    cfg, variables, calib, *_ = setup
    cfg = _config()
    cfg.model.video_backbone = backbone
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        TS.build_quantized_forward(cfg, variables, calib, device="cpu")


@pytest.mark.parametrize("backbone", ["mobilenet_v2", "tiny_cnn"])
def test_towers_without_an_int8_form_raise_as_jax(setup, backbone):
    """The towers the JAX package quantizes no form of raise its ``ValueError``."""
    _, variables, calib, *_ = setup
    cfg = _config()
    cfg.model.video_backbone = backbone
    for build in (jax_build, lambda *args: TS.build_quantized_forward(*args, device="cpu")):
        with pytest.raises(ValueError, match="quantized path supports backbones"):
            build(cfg, variables, calib)


@pytest.mark.parametrize("n", [3, 200])
def test_fit_logit_recalibration_equals_jax(n):
    rng = np.random.default_rng(n)
    lf = rng.normal(0, 3, (n, 5)).astype(np.float32)
    l8 = (0.8 * lf + rng.normal(0, 0.1, (n, 5))).astype(np.float32)
    for kw in ({}, {"shrink_samples": 0}):
        for got, want in zip(TS.fit_logit_recalibration(lf, l8, **kw), jax_fit(lf, l8, **kw)):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="paired"):
        TS.fit_logit_recalibration(lf, l8[:, :4])
