"""The port's serving engine (``tpuhar_torch/serving.py``) vs the JAX package's
``tpuhar/serving.py: InferenceEngine``, on the CPU, in f32.

The same flax variables (JAX ``model.init`` → ``jax.device_get``) and the same seeded
inputs go through both engines. Sizes: the flagship cut as in
``tests/test_torch_slice.py`` (``tpu_cnn`` at full width, IMU d=64 / 4 heads / 2
layers, fusion 4 heads, 8 classes, 4 frames of 64²) with ``batch_sizes=[4]``, and
``videomae_tiny`` on 4 frames of 32² as in ``tests/test_torch_slice_vit.py`` for the
``fast_gelu``/``fast_attention`` cases. The ``tiny_cnn`` fusion engine and the IMU-only
engine with the 1-D CNN encoder are held to the JAX package's in
``tests/test_torch_towers.py`` and ``tests/test_torch_imu_encoders.py``.

Tolerances: logits, MSP, energy and embeddings 1e-4 abs; ``preds`` equal, dtypes
included; Mahalanobis, RMD and KNN scores 1e-4 relative; thresholds from
``calibrate_ood_thresholds`` 1e-5 relative; the ``is_ood_*`` flags equal wherever the
score lies more than the tolerance from its threshold. The int8 engines are compared on
the same calibration statistics (the JAX package's, handed to the port, as
``tests/test_torch_serving_quant.py`` does for its tight case): each package
calibrating itself may move a site scale by its last bit and an int8 code by one step
(5 of the 11 site scales differed in the last bit, and the embeddings by 9e-4, on 2
clips here).

The int8 ResNet-18 engines (``tests/test_serving.py:403``'s configuration: 4 frames of
32²) are held to the JAX package's on its calibration statistics, as above (the
resident one within 1e-2: its test says why). The int8
``videomae_tiny`` engine is held to the JAX package's within 0.1 abs and its predicted
classes: the JAX engine's ``jax.jit`` of ``quant_vit_forward`` does not keep the
function's bf16 roundings (``tests/test_torch_serving_quant.py`` holds the port to the
eager JAX program to 1e-5).

The mesh engine's tests are in ``tests/test_torch_engine_mesh.py`` (two gloo ranks);
here a mesh whose data axis does not divide a registered size is refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.models.crossmodal import FusionClassifier as JaxFusion
from tpuhar.models.crossmodal import IMUClassifier as JaxIMU
from tpuhar.ood import KNNScorer as JaxKNN
from tpuhar.ood import MahalanobisScorer as JaxMaha
from tpuhar.ood import RelativeMahalanobisScorer as JaxRMD
from tpuhar.serving import InferenceEngine as JaxEngine
from tpuhar_torch import ood as TO
from tpuhar_torch import serving_quant as TS
from tpuhar_torch.bridge import _flatten, init_params
from tpuhar_torch.models.crossmodal import IMUClassifier
from tpuhar_torch.serving import InferenceEngine, benchmark_engine

torch.set_num_threads(2)

ATOL = 1e-4  # logits, msp, energy, embeddings
SCORE_RTOL = 1e-4  # mahalanobis, rmd, knn
THRESHOLD_RTOL = 1e-5
FRAMES, SIZE, B = 4, 64, 4
VALUES = ("logits", "msp", "energy", "embeddings")
# int8 calibration clips, as in tests/test_torch_serving_quant.py. The logit
# recalibration fits a per-class affine map to differences between the clips' logits;
# with 2 clips of noise those differences are near zero, and the fit turned the two
# packages' 1e-6 apart int8 logits into maps 5.7e-4 apart (logits 1.7e-4 apart)
NCAL = 6


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


def _vit_config():
    from __graft_entry__ import _flagship_config

    cfg = _flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    return cfg


def _init(model, *shapes):
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), *(jnp.zeros(s) for s in shapes)))


def _inputs(n, seed, size=SIZE):
    rng = np.random.default_rng(seed)
    imu = rng.normal(0, 8000, (n, 250, 6)).astype(np.float32)
    video = rng.integers(0, 256, (n, FRAMES, size, size, 3), dtype=np.uint8)
    return imu, video


def _compare(got, want, *, keys=None, exact=("preds",)):
    """Every output of ``want`` in ``got``: values to ``ATOL``, scores to
    ``SCORE_RTOL``, ``exact`` keys equal; shapes and dtypes equal."""
    keys = keys or set(want)
    assert set(got) == set(want)
    for key in keys:
        g, w = got[key], np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, (key, g.shape, g.dtype, w.shape, w.dtype)
        if key in exact or key.startswith("is_ood_"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif key in VALUES:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=SCORE_RTOL, atol=0, err_msg=key)


@pytest.fixture(scope="module")
def fusion():
    """The tpu_cnn fusion variables and a JAX and a port engine over them."""
    cfg = _config()
    variables = _init(JaxFusion(cfg), (1, 6, 250), (1, FRAMES, SIZE, SIZE, 3))
    jax_engine = JaxEngine(cfg, variables, batch_sizes=[B])
    port = InferenceEngine(cfg, variables, batch_sizes=[B], device="cpu")
    return cfg, variables, jax_engine, port


def test_predict_contract_and_dtypes(fusion):
    """3 < 4 rows: padded internally; every output of the reference with its dtype
    (preds int32, the rest f32)."""
    cfg, _, jax_engine, port = fusion
    imu, video = _inputs(3, 0)
    got = port.predict(imu, video)
    _compare(got, jax_engine.predict(imu, video))
    assert set(got) == {"logits", "preds", "msp", "energy", "embeddings"}
    assert got["logits"].shape == (3, 8) and got["embeddings"].shape == (3, 128)
    assert got["preds"].dtype == np.int32 and got["msp"].dtype == np.float32
    np.testing.assert_array_equal(got["preds"], got["logits"].argmax(-1))
    assert port.patch_major and port.folded
    # the patch-major wire is taken as it is
    from tpuhar_torch.ops.stem import to_patch_major

    again = port.predict(imu, to_patch_major(video))
    np.testing.assert_array_equal(again["logits"], got["logits"])


def test_padding_leaves_rows_alone(fusion):
    _, _, _, port = fusion
    imu, video = _inputs(4, 1)
    full = port.predict(imu, video)
    one = port.predict(imu[2:3], video[2:3])
    np.testing.assert_allclose(one["logits"][0], full["logits"][2], rtol=0, atol=1e-5)


def test_predict_chunks_oversized(fusion):
    _, _, jax_engine, port = fusion
    imu, video = _inputs(9, 2)  # 4 + 4 + 1
    got = port.predict(imu, video)
    assert got["logits"].shape == (9, 8)
    _compare(got, jax_engine.predict(imu, video))
    single = port.predict(imu[5:6], video[5:6])
    np.testing.assert_allclose(got["logits"][5], single["logits"][0], rtol=0, atol=1e-5)


def test_imu_only_engine_with_mahalanobis():
    cfg = _config()
    variables = _init(JaxIMU(cfg), (1, 6, 250))
    ours = init_params(cfg, torch.Generator().manual_seed(0), IMUClassifier)
    assert {k: v.shape for k, v in _flatten(ours)} == {k: v.shape for k, v in _flatten(variables)}
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(50, cfg.model.imu_d_model)).astype(np.float32)
    labels = rng.integers(0, 8, 50)
    jax_engine = JaxEngine(cfg, variables, imu_only=True, batch_sizes=[B], mahalanobis=JaxMaha.fit(emb, labels, 8))
    port = InferenceEngine(
        cfg, variables, imu_only=True, batch_sizes=[B], mahalanobis=TO.MahalanobisScorer.fit(emb, labels, 8),
        device="cpu",
    )
    imu = rng.normal(0, 8000, (3, 250, 6)).astype(np.float32)
    got = port.predict(imu)
    _compare(got, jax_engine.predict(imu))
    assert got["mahalanobis"].shape == (3,) and (got["mahalanobis"] >= 0).all()
    assert got["embeddings"].shape == (3, cfg.model.imu_d_model)
    stream = list(port.predict_stream([imu, {"imu": imu[:2]}, (imu[:1],)]))
    for out, n in zip(stream, (3, 2, 1)):
        np.testing.assert_array_equal(out["logits"], got["logits"][:n])


@pytest.fixture(scope="module")
def scored(fusion):
    """Engines with Mahalanobis, KNN and RMD scorers fitted on served embeddings, and
    a calibration temperature of 2.5, in both packages."""
    cfg, variables, jax_engine, _ = fusion
    imu, video = _inputs(8, 4)
    bank = jax_engine.predict(imu, video)["embeddings"]
    labels = np.random.default_rng(4).integers(0, 8, 8)
    jax_scorers = dict(maha=JaxMaha.fit(bank, labels, 8), knn=JaxKNN.fit(bank, k=3), rmd=JaxRMD.fit(bank, labels, 8))
    port_scorers = dict(
        maha=TO.MahalanobisScorer.fit(bank, labels, 8), knn=TO.KNNScorer.fit(bank, k=3),
        rmd=TO.RelativeMahalanobisScorer.fit(bank, labels, 8),
    )
    engines = []
    for cls, s, kw in ((JaxEngine, jax_scorers, {}), (InferenceEngine, port_scorers, {"device": "cpu"})):
        engines.append(cls(
            cfg, variables, batch_sizes=[B], mahalanobis=s["maha"],
            extra_scorers={"knn": s["knn"], "rmd": s["rmd"]}, temperature=2.5, **kw,
        ))
    return engines


def test_extra_scorers_and_temperature_in_serving_program(fusion, scored):
    _, _, jax_plain, port_plain = fusion
    jax_engine, port = scored
    imu, video = _inputs(3, 5)
    got = port.predict(imu, video)
    _compare(got, jax_engine.predict(imu, video))
    assert {"mahalanobis", "knn", "rmd"} <= set(got) and (got["knn"] >= 0).all()
    # logits and preds untouched by the temperature; msp and energy on logits / T
    plain = port_plain.predict(imu, video)
    np.testing.assert_array_equal(got["logits"], plain["logits"])
    np.testing.assert_array_equal(got["preds"], plain["preds"])
    logits = torch.from_numpy(plain["logits"])
    np.testing.assert_allclose(got["msp"], TO.msp_score(logits / 2.5).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["energy"], TO.energy_score(logits / 2.5).numpy(), rtol=0, atol=1e-5)


def test_latency_summary():
    cfg = _config()
    variables = init_params(cfg, torch.Generator().manual_seed(0))
    port = InferenceEngine(cfg, variables, batch_sizes=[2], device="cpu")
    assert port.latency_summary() == {}
    imu, video = _inputs(2, 6)
    for _ in range(3):
        port.predict(imu, video)
    s = port.latency_summary()
    assert s["steps"] == 3 and s["p50_ms"] > 0
    assert set(s) == {"steps", "mean_ms", "p50_ms", "p90_ms", "p99_ms"}
    result = benchmark_engine(port, 2, iters=2)
    assert result["throughput"] > 0 and result["step_ms"] > 0 and result["lat_steps"] == 6


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_predict_stream_matches_predict(fusion, depth):
    """Padded, full and dict-shaped batches: one output per batch, in order, equal to
    ``predict`` bit for bit."""
    _, _, _, port = fusion
    sizes = [4, 3, 4, 2]
    batches, refs = [], []
    for i, n in enumerate(sizes):
        imu, video = _inputs(n, 10 + i)
        batches.append({"imu": imu, "video": video} if i % 2 else (imu, video))
        refs.append(port.predict(imu, video))
    outs = list(port.predict_stream(iter(batches), depth=depth))
    assert len(outs) == len(sizes)
    for out, ref in zip(outs, refs):
        assert set(out) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


def test_predict_stream_empty_and_oversized(fusion):
    _, _, _, port = fusion
    assert list(port.predict_stream(iter([]))) == []
    imu, video = _inputs(5, 20)  # > the largest registered 4
    with pytest.raises(ValueError, match="largest registered"):
        list(port.predict_stream([(imu, video)]))


@pytest.fixture(scope="module")
def int8(fusion):
    """The baseline and resident int8 engines of both packages, calibrated on the
    same two clips; the port handed the JAX package's calibration statistics, taken on
    the JAX package's normalization of the clips (the two normalizations differ in the
    last bit, and so then may a site scale)."""
    from tpuhar.ops.quant import calibrate_tpucnn as jax_calibrate
    from tpuhar.ops.video import normalize_clip as jax_normalize

    cfg, variables, _, _ = fusion
    calib = _inputs(NCAL, 30)[1]
    frames = np.asarray(jax.jit(jax_normalize)(calib)).reshape(-1, SIZE, SIZE, 3)
    video_encoder = variables["params"]["video_encoder"]["backbone"], variables["batch_stats"]["video_encoder"]["backbone"]
    act_stats = jax_calibrate(*video_encoder, frames)
    engines = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "calibrate_tpucnn", lambda *args: act_stats)
        for resident in (False, True):
            kw = dict(batch_sizes=[B], quantize_calib_clips=calib, quantize_resident=resident)
            engines[resident] = (
                JaxEngine(cfg, variables, **kw),
                InferenceEngine(cfg, variables, verify_byte_map=True, device="cpu", **kw),
            )
        # the quirk: the refit engine serves the baseline tower, not the resident one
        imu, video = _inputs(6, 31)
        labels = np.random.default_rng(31).integers(0, 8, 6)
        refit = engines[True][1].fit_embedding_scorers(imu, video, labels, scores=("rmd",))
    return engines, refit


@pytest.mark.parametrize("resident", [False, True], ids=["baseline", "resident"])
def test_quantized_engine(int8, resident):
    engines, _ = int8
    jax_engine, port = engines[resident]
    assert port.quantized and port.patch_major and not port.folded
    imu, video = _inputs(3, 32)
    _compare(port.predict(imu, video), jax_engine.predict(imu, video))


def test_quantized_refit_serves_the_baseline_tower(int8):
    """``fit_embedding_scorers`` rebuilds without ``quantize_resident``, as the
    reference does (``serving.py:406-414``): the refit of a resident engine serves
    what the baseline engine serves, bit for bit, plus its new score."""
    engines, refit = int8
    imu, video = _inputs(3, 33)
    got = refit.predict(imu, video)
    base = engines[False][1].predict(imu, video)
    for key in base:
        np.testing.assert_array_equal(got[key], base[key], err_msg=key)
    assert refit._ctor["quantize_resident"] is False and got["rmd"].shape == (3,)


@pytest.mark.parametrize(
    "kw,error,match",
    [
        (dict(imu_only=True, quantize_calib_clips=np.zeros((2, FRAMES, SIZE, SIZE, 3), np.uint8)), ValueError, "imu_only"),
        (dict(quantize_calib_imu=np.zeros((2, 250, 6), np.float32)), ValueError, "quantize_calib_clips"),
    ],
    ids=["imu_only_int8", "calib_imu_alone"],
)
def test_refusals_match_the_reference(fusion, kw, error, match):
    cfg, variables, _, _ = fusion
    with pytest.raises(error, match=match):
        JaxEngine(cfg, variables, **kw)
    with pytest.raises(error, match=match):
        InferenceEngine(cfg, variables, device="cpu", **kw)


def test_what_is_not_ported_raises(fusion, monkeypatch):
    """A mesh whose data axis does not divide a registered batch size (the mesh itself is
    ported: ``tests/test_torch_engine_mesh.py``) and the card asked for where there is
    none; an unknown wire
    raises as the reference's ``serving.py:202-203`` does (which calibrates first: its
    test would cost seconds). ``from_checkpoint`` is ported: a path holding no checkpoint
    raises."""
    cfg, variables, _, _ = fusion
    clips = np.zeros((2, FRAMES, SIZE, SIZE, 3), np.uint8)
    with pytest.raises(ValueError, match="int8_wire must be 'u8' or 'centered', got 'i8'"):
        InferenceEngine(cfg, variables, quantize_calib_clips=clips, int8_wire="i8", device="cpu")
    class TwoRanks:  # what the engine reads of a (2, 1) mesh
        mesh_dim_names = ("data", "model")

        def get_local_rank(self, axis):
            return 0

        def __getitem__(self, axis):
            return type("Dim", (), {"size": lambda self: 2})()

        def get_group(self, axis):
            return None

    with pytest.raises(ValueError, match=r"batch sizes \[3\] do not divide"):
        InferenceEngine(cfg, variables, batch_sizes=[3, 4], mesh=TwoRanks(), device="cpu")
    with pytest.raises(FileNotFoundError):
        InferenceEngine.from_checkpoint(cfg, "no/such/checkpoint", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        InferenceEngine(cfg, variables)  # the default device is the card


def test_engine_ood_threshold_calibration(fusion):
    cfg, variables, jax_base, _ = fusion
    engines = (JaxEngine(cfg, variables, batch_sizes=[B]), InferenceEngine(cfg, variables, batch_sizes=[B], device="cpu"))
    imu, video = _inputs(12, 40)  # three chunks of 4
    assert "is_ood_msp" not in engines[1].predict(imu[:4], video[:4])
    thr_jax, thr = (e.calibrate_ood_thresholds(imu, video, id_fpr=0.10) for e in engines)
    assert set(thr) == set(thr_jax) == {"msp", "energy"} and engines[1].ood_thresholds == thr
    for name in thr:
        np.testing.assert_allclose(thr[name], thr_jax[name], rtol=THRESHOLD_RTOL, atol=0, err_msg=name)
    got, want = (e.predict(imu, video) for e in engines)
    for name in ("msp", "energy"):
        flags = got[f"is_ood_{name}"]
        assert flags.dtype == bool and flags.shape == (12,)
        np.testing.assert_array_equal(flags, got[name] >= thr[name])
        clear = np.abs(got[name] - thr[name]) > ATOL
        np.testing.assert_array_equal(flags[clear], want[f"is_ood_{name}"][clear])
        assert flags.mean() <= 0.25
    stream_out = next(iter(engines[1].predict_stream([(imu[:4], video[:4])])))
    np.testing.assert_array_equal(stream_out["is_ood_msp"], got["is_ood_msp"][:4])
    engines[1].ood_thresholds = {"msp": -np.inf, "energy": np.inf}
    forced = engines[1].predict(imu[:4], video[:4])
    assert forced["is_ood_msp"].all() and not forced["is_ood_energy"].any()


def test_fit_embedding_scorers_deployment_refit(fusion):
    cfg, variables, jax_engine, port = fusion
    imu, video = _inputs(12, 50)
    labels = np.random.default_rng(50).integers(0, 8, 12)
    with pytest.raises(ValueError, match="Unknown"):
        port.fit_embedding_scorers(imu, video, scores=("bogus",))
    with pytest.raises(ValueError, match="labels"):
        port.fit_embedding_scorers(imu, video, scores=("mahalanobis",))
    kw = dict(scores=("mahalanobis", "knn", "rmd"), knn_k=3)
    refit = port.fit_embedding_scorers(imu, video, labels, **kw)
    jax_refit = jax_engine.fit_embedding_scorers(imu, video, labels, **kw)
    got = refit.predict(imu[:3], video[:3])
    assert {"mahalanobis", "knn", "rmd"} <= set(got)
    _compare(got, jax_refit.predict(imu[:3], video[:3]), keys=VALUES + ("preds", "knn"))
    # Mahalanobis and RMD: the two refits fit on served embeddings 1e-6 apart, and 12
    # rows of 128 dims leave the regularized covariance ill-conditioned (as the
    # reference's fit says); so the JAX package fits on the port's served embeddings
    emb = port.predict(imu, video)["embeddings"]
    for name, fit in (("mahalanobis", JaxMaha.fit), ("rmd", JaxRMD.fit)):
        want = np.asarray(fit(emb, labels, 8).score(got["embeddings"]))
        np.testing.assert_allclose(got[name], want, rtol=SCORE_RTOL, atol=0, err_msg=name)
    np.testing.assert_allclose(
        got["knn"], TO.KNNScorer.fit(emb, k=3).score(emb[:3]).numpy(), rtol=SCORE_RTOL, atol=0
    )
    assert "knn" not in port.predict(imu[:3], video[:3])  # the original engine is untouched


@pytest.fixture(scope="module")
def vit():
    cfg = _vit_config()
    return cfg, _init(JaxFusion(cfg), (1, 6, 250), (1, FRAMES, 32, 32, 3))


@pytest.mark.parametrize(
    "kw,gelu,flash",
    [({}, True, False), ({"fast_gelu": False}, False, False), ({"fast_attention": True}, True, True)],
    ids=["default", "exact_gelu", "fast_attention"],
)
def test_vit_serving_overrides(vit, kw, gelu, flash):
    """``fast_gelu`` (default on) and ``fast_attention`` (default off) on a copy of
    the config; the caller's config is untouched."""
    cfg, variables = vit
    jax_engine = JaxEngine(cfg, variables, batch_sizes=[2], **kw)
    port = InferenceEngine(cfg, variables, batch_sizes=[2], device="cpu", **kw)
    for engine in (jax_engine, port):
        assert engine.config.model.gelu_approximate is gelu
        assert engine.config.model.use_flash_attention is flash
    assert cfg.model.gelu_approximate is False and cfg.model.use_flash_attention is False
    assert not port.patch_major  # the ViT takes NHWC clips
    imu, video = _inputs(2, 60, size=32)
    _compare(port.predict(imu, video), jax_engine.predict(imu, video))
    if flash:  # the quirk: the refit forgets fast_attention (and fast_gelu's value)
        refit = port.fit_embedding_scorers(imu, video, scores=("knn",), knn_k=1)
        assert refit.config.model.use_flash_attention is False
        assert refit.config.model.gelu_approximate is True


def test_vit_overrides_are_noops_for_cnn_towers(fusion):
    cfg, variables, jax_engine, port = fusion
    for engine in (jax_engine, port):
        assert engine.config.model.gelu_approximate is False
        assert engine.config.model.use_flash_attention is False
    fast = InferenceEngine(cfg, variables, batch_sizes=[B], fast_attention=True, device="cpu")
    assert fast.config is cfg and fast.config.model.use_flash_attention is False


def _resnet_config():
    """``tests/test_serving.py``'s ``_cfg()`` with its ResNet-18 tower."""
    from tpuhar.config import Config

    cfg = Config()
    m = cfg.model
    m.num_classes, m.imu_num_layers, m.imu_d_model, m.imu_nhead, m.fusion_heads = 4, 1, 32, 4, 4
    m.classifier_hidden_dims = [16]
    m.compute_dtype = "float32"
    m.head_norm = "layer"
    m.video_backbone = "resnet18"
    m.video_d_model = 32
    cfg.data.video_resize = (32, 32)
    cfg.data.video_frames_per_window = 4
    return cfg


@pytest.fixture(scope="module")
def int8_resnet():
    """The baseline and resident int8 ResNet-18 engines of both packages, calibrated on
    the same ``NCAL`` clips; the port handed the JAX package's calibration statistics,
    taken on the JAX package's normalization of the clips."""
    from tpuhar.ops.quant import calibrate_resnet18 as jax_calibrate
    from tpuhar.ops.video import normalize_clip as jax_normalize

    cfg = _resnet_config()
    variables = _init(JaxFusion(cfg), (2, 6, 250), (2, FRAMES, 32, 32, 3))
    calib = _inputs(NCAL, 70, size=32)[1]
    frames = np.asarray(jax.jit(jax_normalize)(calib)).reshape(-1, 32, 32, 3)
    venc = variables["params"]["video_encoder"]["backbone"], variables["batch_stats"]["video_encoder"]["backbone"]
    act_stats = jax_calibrate(*venc, frames)
    engines = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "calibrate_resnet18", lambda *args: act_stats)
        for resident in (False, True):
            kw = dict(batch_sizes=[4], quantize_calib_clips=calib, quantize_resident=resident)
            engines[resident] = (JaxEngine(cfg, variables, **kw), InferenceEngine(cfg, variables, device="cpu", **kw))
    return engines


@pytest.mark.parametrize("resident", [False, True], ids=["baseline", "resident"])
def test_quantized_resnet18_engine(int8_resnet, resident):
    """The baseline engine to the module's tolerances. The resident engine within 1e-2
    abs and the same predicted classes: the JAX engine fits its logit map on its
    ``jax.jit`` program, whose resident tower moved the calibration clips' logits by
    6.1e-3 from the JAX package's eager program here (the port's equal that one to
    3.6e-7), and a map fitted on six clips carries that to 1.6e-3 on the logits."""
    jax_engine, port = int8_resnet[resident]
    assert port.quantized and not port.patch_major and not port.folded
    assert "layer0_0" in port.quantized_forward.quantized_tree
    imu, video = _inputs(3, 71, size=32)
    got, want = port.predict(imu, video), jax_engine.predict(imu, video)
    if not resident:
        _compare(got, want)
        return
    assert set(got) == set(want)
    for key in VALUES:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-2, err_msg=key)
    np.testing.assert_array_equal(got["preds"], want["preds"])


def test_quantized_engine_resident_resnet18(int8_resnet):
    """``tests/test_serving.py::test_quantized_engine_resident_resnet18`` on the port's
    engines: the resident engine's logits finite and tracking the baseline engine's
    (relative RMS drift < 0.10, correlation > 0.99, that test's bounds)."""
    imu, video = _inputs(4, 72, size=32)
    out_b, out_r = (int8_resnet[resident][1].predict(imu, video) for resident in (False, True))
    for key in ("logits", "preds", "msp", "energy", "embeddings"):
        assert out_r[key].shape == out_b[key].shape
    assert np.isfinite(out_r["logits"]).all()
    base, res = (np.asarray(o["logits"], np.float64) for o in (out_b, out_r))
    spread = np.sqrt(np.mean((base - base.mean()) ** 2))
    assert np.sqrt(np.mean((res - base) ** 2)) / max(spread, 1e-12) < 0.10
    assert np.corrcoef(res.ravel(), base.ravel())[0, 1] > 0.99


def test_quantized_vit_engine(vit):
    """The int8 ``videomae_tiny`` engine (``fast_gelu`` on, as served) against the JAX
    package's: the clip NHWC, the same site scales from the JAX package's statistics;
    outputs within 0.1 abs (the JAX engine's jit drops bf16 roundings, module
    docstring) and the same predicted classes."""
    from tpuhar.ops.quant_vit import calibrate_vit as jax_calibrate
    from tpuhar.ops.video import normalize_clip as jax_normalize

    cfg, variables = vit
    calib = _inputs(NCAL, 73, size=32)[1]
    act_stats = jax_calibrate(variables["params"]["video_encoder"]["vit"], {}, np.asarray(jax.jit(jax_normalize)(calib)))
    kw = dict(batch_sizes=[2], quantize_calib_clips=calib)
    jax_engine = JaxEngine(cfg, variables, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "calibrate_vit", lambda *args: act_stats)
        port = InferenceEngine(cfg, variables, device="cpu", verify_byte_map=True, **kw)
    assert port.quantized and not port.patch_major and port.config.model.gelu_approximate
    q = port.quantized_forward.quantized_tree
    assert q["input_fold"] and q["depth"] == 4 and q["act_scales"]["block3.mlp_mid"] == float(
        np.float32(act_stats["block3.mlp_mid"] / 127.0))
    imu, video = _inputs(2, 74, size=32)
    got, want = port.predict(imu, video), jax_engine.predict(imu, video)
    assert set(got) == set(want)
    for key in VALUES:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=0.1, err_msg=key)
    np.testing.assert_array_equal(got["preds"], want["preds"])
