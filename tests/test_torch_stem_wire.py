"""The centered int8 wire (``tpuhar_torch/ops/stem.py``, ``tpuhar_torch/serving.py``)
against the JAX package's (``tpuhar/ops/stem.py:62-112``, ``tpuhar/serving.py:202-214``),
on the CPU.

- ``center_u8`` and ``to_patch_major(centered=True)``: byte for byte, over all 256 byte
  values and over a random clip.
- ``stem_gemm_u8`` on int8 codes: bit for bit with the JAX package's ``stem_gemm_u8`` on
  the same codes (its ``pre_centered`` branch) and with the port's result on the uint8
  wire of the same pixels, f32 and requantized int8 out.
- ``InferenceEngine(int8_wire="centered")`` on a ``tpu_cnn`` fusion model cut to test
  size (the tower's full widths, IMU d=32 / 4 heads / 1 layer, one fusion round, 8
  classes, 2 frames of 32², variables drawn by ``bridge.init_params``): against the JAX
  package's centered engine on the same calibration statistics (the JAX package's,
  computed once and handed to both engines) within 1e-5 abs for logits, MSP, energy and
  embeddings and equal predictions, the tight bound ``tests/test_torch_serving_quant.py``
  states for the uint8 engine; against the port's uint8 engine bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.ops import stem as JS
from tpuhar_torch.ops import stem as TS

torch.set_num_threads(2)

FRAMES, SIZE, B, NCAL = 2, 32, 3, 6
TIGHT = 1e-5


def test_center_u8_matches_jax_on_every_byte():
    col = np.arange(256, dtype=np.uint8).reshape(1, 256)
    got = TS.center_u8(col)
    want = JS.center_u8(col)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0].astype(np.int64), np.clip(np.arange(256) - 128, -127, 127))


def test_to_patch_major_centered_matches_jax():
    clip = np.random.default_rng(0).integers(0, 256, (2, 3, 64, 48, 3), dtype=np.uint8)
    for centered in (False, True):
        got, want = TS.to_patch_major(clip, 16, centered=centered), JS.to_patch_major(clip, 16, centered=centered)
        assert got.dtype == want.dtype and got.shape == want.shape == (2, 3, 4, 3, 768)
        np.testing.assert_array_equal(got, want)
    device_side = TS.to_patch_major_tensor(torch.from_numpy(clip), 16)
    np.testing.assert_array_equal(device_side.numpy(), np.asarray(JS.to_patch_major_jnp(jnp.asarray(clip), 16)))
    assert TS.is_patch_major(device_side, 16) and not TS.is_patch_major(torch.from_numpy(clip), 16)
    assert TS.is_patch_major(device_side, 16) == JS.is_patch_major(device_side, 16)


@pytest.mark.parametrize("out_scale", [None, 0.37], ids=["f32", "int8_out"])
def test_stem_gemm_on_centered_codes_matches_jax_and_the_u8_wire(out_scale):
    rng = np.random.default_rng(1)
    K, C0 = 768, 64
    # every byte value, then random pixels
    u8 = np.concatenate([np.arange(256, dtype=np.uint8).repeat(3)[:K][None], rng.integers(0, 256, (40, K), dtype=np.uint8)])
    codes = TS.center_u8(u8)
    w = rng.integers(-127, 128, (K, C0), dtype=np.int8)
    scale = rng.uniform(1e-4, 1e-3, C0).astype(np.float32)
    bias = rng.normal(0, 0.5, C0).astype(np.float32)
    out_dtype = jnp.float32 if out_scale is None else jnp.int8
    want = np.asarray(JS.stem_gemm_u8(
        jnp.asarray(codes), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
        relu=True, out_scale=out_scale, out_dtype=out_dtype,
    ))
    w_packed = torch.from_numpy(w.T.copy())
    args = (w_packed, torch.from_numpy(scale), torch.from_numpy(bias))
    got = TS.stem_gemm_u8(torch.from_numpy(codes), *args, relu=True, out_scale=out_scale).numpy()
    u8_wire = TS.stem_gemm_u8(torch.from_numpy(u8), *args, relu=True, out_scale=out_scale).numpy()
    assert got.dtype == want.dtype == u8_wire.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, u8_wire)


def test_stem_gemm_refuses_other_dtypes():
    w = torch.zeros(32, 64, dtype=torch.int8)
    with pytest.raises(TypeError, match="uint8 patch-major pixels or their centered int8 codes"):
        TS.stem_gemm_u8(torch.zeros(2, 64, dtype=torch.int16), w, torch.ones(32), torch.zeros(32))


def _config():
    from __graft_entry__ import _flagship_config

    cfg = _flagship_config()
    m = cfg.model
    m.compute_dtype = "float32"
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 32, 4, 1
    m.fusion_heads, m.fusion_layers, m.video_d_model = 4, 1, 48
    m.num_classes = 8
    cfg.data.video_resize = (SIZE, SIZE)
    cfg.data.video_frames_per_window = FRAMES
    return cfg


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    imu = rng.normal(0, 8000, (n, 250, 6)).astype(np.float32)
    video = rng.integers(0, 256, (n, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
    return imu, video


@pytest.fixture(scope="module")
def engines():
    """The JAX package's centered engine and the port's centered and uint8 engines
    (baseline and resident), the port on the JAX package's calibration statistics."""
    import tpuhar.serving_quant as JSQ
    from tpuhar.ops.quant import calibrate_tpucnn as jax_calibrate
    from tpuhar.ops.video import normalize_clip as jax_normalize
    from tpuhar.serving import InferenceEngine as JaxEngine
    from tpuhar_torch import serving_quant as TSQ
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.serving import InferenceEngine

    cfg = _config()
    # a flax-layout tree both packages load (JAX's jitted init of these widths: 9 s on a CPU)
    variables = init_params(cfg, torch.Generator().manual_seed(0))
    calib = _inputs(NCAL, 40)[1]
    frames = np.asarray(jax.jit(jax_normalize)(calib)).reshape(-1, SIZE, SIZE, 3)
    venc = variables["params"]["video_encoder"]["backbone"], variables["batch_stats"]["video_encoder"]["backbone"]
    act_stats = jax_calibrate(*venc, frames)
    kw = dict(batch_sizes=[4], quantize_calib_clips=calib)
    port = {}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX engine calibrates on the same normalized frames: its own walk would
        # give these statistics again, in 4 s
        mp.setitem(JSQ._QUANT_BACKBONES, "tpu_cnn", (lambda *args: act_stats,) + JSQ._QUANT_BACKBONES["tpu_cnn"][1:])
        jax_engine = JaxEngine(cfg, variables, quantize_resident=True, int8_wire="centered", **kw)
        mp.setattr(TSQ, "calibrate_tpucnn", lambda *args: act_stats)
        for resident in (False, True):
            for wire in ("u8", "centered"):
                port[resident, wire] = InferenceEngine(
                    cfg, variables, quantize_resident=resident, int8_wire=wire, verify_byte_map=True,
                    device="cpu", **kw,
                )
    return jax_engine, port


def test_centered_engine_matches_jax(engines):
    jax_engine, port = engines
    engine = port[True, "centered"]
    assert engine.patch_major and engine._wire_centered and jax_engine._wire_centered
    assert engine._input_specs(4)[1] == ((4, FRAMES, SIZE // 16, SIZE // 16, 768), torch.int8)
    imu, video = _inputs(B, 41)
    got, want = engine.predict(imu, video), jax_engine.predict(imu, video)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["preds"], np.asarray(want["preds"]))
    for key in ("logits", "msp", "energy", "embeddings"):
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=TIGHT, err_msg=key)


@pytest.mark.parametrize("resident", [False, True], ids=["baseline", "resident"])
def test_centered_engine_equals_the_u8_engine(engines, resident):
    _, port = engines
    imu, video = _inputs(B, 42)
    centered, u8 = port[resident, "centered"], port[resident, "u8"]
    assert centered._input_specs(4)[1][1] == torch.int8 and u8._input_specs(4)[1][1] == torch.uint8
    want = u8.predict(imu, video)
    # NHWC clips, and clips already patch-major on either wire, give the same bits
    for clip in (video, TS.to_patch_major(video), TS.to_patch_major(video, centered=True)):
        for engine in (centered, u8):
            got = engine.predict(imu, clip)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
