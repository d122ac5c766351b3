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
        assert got.shape == ref.shape == want["logits"].shape[-1:]
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


def _tower_config(backbone):
    """``tests/test_serving_quant.py:14``'s configuration for ``resnet18`` (2 frames of
    64²), ``tests/test_quant_vit.py:115``'s for ``videomae_tiny`` (2 frames of 32²)."""
    from tpuhar.config import Config

    cfg = Config()
    m = cfg.model
    m.num_classes, m.imu_num_layers, m.imu_d_model, m.imu_nhead, m.fusion_heads = 5, 1, 32, 4, 4
    m.classifier_hidden_dims = [16]
    m.compute_dtype = "float32"
    m.head_norm = "layer"
    m.video_backbone = backbone
    m.video_d_model = 64
    size = 64 if backbone == "resnet18" else 32
    cfg.data.video_resize = (size, size)
    cfg.data.video_frames_per_window = 2
    return cfg


TOWERS = [("resnet18", False), ("resnet18", True), ("videomae_tiny", False)]


@pytest.fixture(scope="module", params=TOWERS, ids=["resnet18-baseline", "resnet18-resident", "videomae_tiny"])
def tower(request):
    """A tower's fusion variables, calibration clips and request; JAX's program, its
    outputs under ``jax.jit`` (and, for the ViT, eagerly), and its calibration
    statistics, taken on its own normalization of the clips."""
    from tpuhar.models.crossmodal import FusionClassifier
    from tpuhar.ops.quant import calibrate_resnet18
    from tpuhar.ops.quant_vit import calibrate_vit
    from tpuhar.ops.video import normalize_clip

    backbone, resident = request.param
    cfg = _tower_config(backbone)
    size = cfg.data.video_resize[0]
    variables = jax.device_get(
        jax.jit(FusionClassifier(cfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 6, 250)), jnp.zeros((1, 2, size, size, 3)))
    )
    rng = np.random.default_rng(5)
    calib = (rng.random((4, 2, size, size, 3)) * 255).astype(np.uint8)
    imu = rng.normal(0, 8000, (3, 250, 6)).astype(np.float32)
    clip = rng.integers(0, 256, (3, 2, size, size, 3), dtype=np.uint8)
    fn = jax_build(cfg, variables, calib, resident=resident)
    # the eager call only where it differs from the jitted one: the ViT's bf16 roundings
    eager = {k: np.asarray(v) for k, v in fn(imu, clip).items()} if backbone != "resnet18" else None
    jitted = {k: np.asarray(v) for k, v in jax.jit(fn)(imu, clip).items()}
    norm = np.asarray(jax.jit(normalize_clip)(calib))
    venc = variables["params"]["video_encoder"]
    if backbone == "resnet18":
        frames = norm.reshape(-1, size, size, 3)[:64]
        stats = ("calibrate_resnet18", calibrate_resnet18(venc["backbone"], variables["batch_stats"]["video_encoder"]["backbone"], frames))
    else:
        stats = ("calibrate_vit", calibrate_vit(venc["vit"], {}, norm[:32]))
    return cfg, variables, calib, imu, clip, resident, fn, eager, jitted, stats


def test_new_towers_match_jax_on_the_same_calibration(tower, monkeypatch):
    """The JAX package's calibration statistics handed to the port: every int8 code of
    the tower is equal. ResNet-18's program and its logit map against JAX's to 1e-5
    (1.7e-6 measured). The ViT against JAX's program called eagerly with JAX's logit map:
    ``jax.jit`` of ``quant_vit_forward`` on the CPU does not keep the function's bf16
    roundings (its tokens moved 0.06 from the eager call's at ``videomae_tiny``, and its
    recalibration is fitted on those), so the ViT's map is held to JAX's to 2e-2 (1.2e-2
    measured) and its program, on JAX's map, to 1e-5 (8.3e-7 measured)."""
    from tpuhar_torch.bridge import load_variables
    from tpuhar_torch.models.crossmodal import FusionClassifier

    cfg, variables, calib, imu, clip, resident, fn, eager, jitted, (name, stats) = tower
    monkeypatch.setattr(TS, name, lambda *args: stats)
    port = TS.build_quantized_forward(cfg, variables, calib, device="cpu", resident=resident)
    if cfg.model.video_backbone == "resnet18":
        out = {k: v.numpy() for k, v in port(torch.from_numpy(imu), torch.from_numpy(clip)).items()}
        _compare(port, out, fn.recalibration, jitted, TIGHT)
        return
    for got, ref in zip(port.recalibration, fn.recalibration):
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
    model = load_variables(FusionClassifier(cfg), variables).eval()
    program = TS.quantized_forward(
        cfg, model, port.quantized_tree, variables["params"]["video_encoder"]["projection"], device="cpu",
        recalibration=fn.recalibration,
    )
    out = {k: v.numpy() for k, v in program(torch.from_numpy(imu), torch.from_numpy(clip)).items()}
    _compare(program, out, fn.recalibration, eager, TIGHT)


def test_new_towers_match_jax(tower):
    """Each package calibrating itself, the port against JAX's program as it serves
    (``jax.jit``). The two f32 normalizations differ in the last bit on 46% of the pixels
    and the f32 calibration walks sum in other orders, so site scales differ by up to
    1.4e-6 relative and move some int8 codes by one step, which a random net carries to
    the logits; the ViT adds the jit's bf16 roundings (above). Measured, of logits up to
    1.1 and embeddings up to 4.9: ResNet-18 baseline 1.0e-2 and 4.3e-2, resident 1.6e-2
    and 5.9e-2, ``videomae_tiny`` 3.3e-2 and 5.0e-2; held to 0.1 abs, and the predicted
    class equal."""
    cfg, variables, calib, imu, clip, resident, fn, eager, jitted, _ = tower
    port = TS.build_quantized_forward(cfg, variables, calib, device="cpu", resident=resident)
    out = {k: v.numpy() for k, v in port(torch.from_numpy(imu), torch.from_numpy(clip)).items()}
    _compare(port, out, fn.recalibration, jitted, 0.1)
    np.testing.assert_array_equal(out["logits"].argmax(-1), jitted["logits"].argmax(-1))
    q = port.quantized_tree
    if cfg.model.video_backbone == "resnet18":
        assert q["stem"]["w_packed"].shape == (64, 192) and q["layer3_0"]["downsample"]["w_packed"].shape == (512, 256)
    else:
        assert q["depth"] == 4 and q["input_fold"] and q["block0"]["qkv"]["w_packed"].shape == (576, 192)


def test_vit_resident_raises_as_jax():
    """``resident=True`` is CNN-only: a ViT raises the JAX package's ``ValueError`` before
    anything is built."""
    cfg = _tower_config("videomae_tiny")
    clips = np.zeros((1, 2, 32, 32, 3), np.uint8)
    for build in (jax_build, lambda *args, **kw: TS.build_quantized_forward(*args, device="cpu", **kw)):
        with pytest.raises(ValueError, match="CNN-only"):
            build(cfg, {}, clips, resident=True)


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
