"""The port's video towers against the JAX package's, on the same parameters and clips:
ResNet-18, MobileNetV2, ``tpu_cnn``, ``tpu_cnn_large`` and ``TinyVideoCNN``, each inside
the ``VideoEncoder`` (tower, per-frame projection to 64, temporal mean), in eval and in
train mode; the fresh variable tree of every backbone and IMU encoder against JAX's
``model.init`` tree; and the fusion engine with ``tiny_cnn`` against
``tpuhar.serving.InferenceEngine``.

Sizes: ResNet-18 and MobileNetV2 at their full widths on 8 frames (2 clips of 4) of
64², the ``tpu_cnn`` towers at theirs on 8 frames of 64² (4² tokens after the stem),
``TinyVideoCNN`` on 8 frames of 32². f32 on both sides; JAX's ``init`` draws the
parameters, the port loads them through ``bridge``; each clip is standard normal, as a
normalized clip is.

Tolerances:

- eval: the embedding and the tokens within 1e-5 of the output's largest element;
- train (BatchNorm over the batch): the outputs and the moved running statistics are
  held to the same flax module run in float64 (``jax.enable_x64``): within 1e-5 of the
  output's largest element (statistics: 1e-5 absolute) plus the JAX package's own f32
  distance from that float64 run. Each train-mode BatchNorm forms its variance as
  E[x²] − E[x]² from f32 sums, a difference that amplifies the sums' rounding, and
  MobileNetV2 chains 52 of them: in either package its f32 outputs and statistics lie
  further than 1e-5 from the float64 run, so the two packages' f32 outputs cannot agree
  to 1e-5. The port is therefore held to be no further from the float64 function than
  the JAX package's own f32 program is, plus 1e-5;
- the engine: logits, MSP, energy and embeddings within 1e-5 of their largest element,
  the predictions exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.models.video import VideoEncoder as JaxVideoEncoder
from tpuhar_torch.bridge import _flatten, init_params, load_variables, variables_to_numpy
from tpuhar_torch.models.crossmodal import FusionClassifier, IMUClassifier
from tpuhar_torch.models.video import CNN_FEATURE_DIMS, VideoEncoder, build_video_encoder
from tpuhar_torch.serving import InferenceEngine, kernel_launches

torch.set_num_threads(2)

OUT_RTOL = 1e-5
STATS_ATOL = 1e-5
D_VIDEO = 64
# backbone -> (clips, frames a clip, side)
SIZES = {
    "resnet18": (2, 4, 64),
    "mobilenet_v2": (2, 4, 64),
    "tpu_cnn": (2, 4, 64),
    "tpu_cnn_large": (2, 4, 64),
    "tiny_cnn": (2, 4, 32),
}


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in _flatten(tree)}


def _jax_run(backbone, variables, clip, train, dtype):
    model = JaxVideoEncoder(backbone=backbone, video_d_model=D_VIDEO, dtype=dtype)
    variables = jax.tree.map(lambda v: np.asarray(v, dtype), variables)
    clip = clip.astype(dtype)
    if train:
        (emb, tokens), updated = jax.jit(
            lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(variables, clip)
        stats = _flat(jax.device_get(updated["batch_stats"]))
    else:
        emb, tokens = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, clip)
        stats = {}
    return np.asarray(emb, np.float64), np.asarray(tokens, np.float64), stats


@pytest.fixture(scope="module")
def towers():
    """backbone -> (JAX's fresh variables, the clip), drawn once for both modes."""
    cache = {}

    def get(backbone):
        if backbone not in cache:
            clips, frames, side = SIZES[backbone]
            rng = np.random.default_rng(len(backbone))
            clip = rng.standard_normal((clips, frames, side, side, 3)).astype(np.float32)
            model = JaxVideoEncoder(backbone=backbone, video_d_model=D_VIDEO, dtype=jnp.float32)
            variables = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), clip[:1]))
            cache[backbone] = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}, clip
        return cache[backbone]

    return get


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("backbone", list(SIZES))
def test_tower_matches_jax(towers, backbone, train):
    clips, frames, _ = SIZES[backbone]
    variables, clip = towers(backbone)

    port = load_variables(VideoEncoder(backbone, D_VIDEO, dtype=torch.float32), variables)
    with torch.no_grad():
        emb, tokens = port(torch.from_numpy(clip), train=train)
    got = {"emb": emb.numpy(), "tokens": tokens.numpy()}
    assert got["emb"].shape == (clips, D_VIDEO) and got["tokens"].shape == (clips, frames, D_VIDEO)
    want32 = dict(zip(("emb", "tokens", "stats"), _jax_run(backbone, variables, clip, train, jnp.float32)))
    if not train:
        for key in ("emb", "tokens"):
            np.testing.assert_allclose(got[key], want32[key], rtol=0, atol=OUT_RTOL * np.abs(want32[key]).max(),
                                       err_msg=key)
        initial = _flat(variables["batch_stats"])
        for name, v in _flat(variables_to_numpy(port)["batch_stats"]).items():
            assert np.array_equal(v, initial[name]), name  # eval moves no statistic
        return
    with jax.enable_x64(True):
        want64 = dict(zip(("emb", "tokens", "stats"), _jax_run(backbone, variables, clip, True, jnp.float64)))
    for key in ("emb", "tokens"):
        own = np.abs(want32[key] - want64[key]).max()  # the JAX package's f32 rounding
        err = np.abs(got[key] - want64[key]).max()
        assert err <= OUT_RTOL * np.abs(want64[key]).max() + own, (key, err, own)
    stats = _flat(variables_to_numpy(port)["batch_stats"])
    assert stats.keys() == want64["stats"].keys()
    moved = 0
    for name, w in want64["stats"].items():
        own = np.abs(want32["stats"][name] - w).max()
        err = np.abs(stats[name] - w).max()
        assert err <= STATS_ATOL + own, (name, err, own)
        moved += not np.array_equal(stats[name], _flat(variables["batch_stats"])[name])
    assert moved == len(stats)  # every running statistic moved


def _tree_shapes(tree):
    return {"/".join(k): tuple(v.shape) for k, v in _flatten(tree)}


def _jax_config(backbone="tpu_cnn", imu_encoder="transformer", featurizer="raw"):
    from tpuhar.config import Config

    cfg = Config()
    cfg.model.video_backbone, cfg.model.imu_encoder = backbone, imu_encoder
    cfg.data.imu_featurizer = featurizer
    cfg.model.compute_dtype = "float32"
    return cfg


# (model, video backbone, IMU encoder, IMU featurizer)
TREES = {
    **{bb: ("fusion", bb, "transformer", "raw") for bb in CNN_FEATURE_DIMS},
    "videomae_tiny": ("fusion", "videomae_tiny", "transformer", "raw"),
    "imu_transformer": ("imu", "tpu_cnn", "transformer", "raw"),
    "imu_cnn": ("imu", "tpu_cnn", "cnn", "raw"),
    "imu_stft": ("imu", "tpu_cnn", "transformer", "stft"),
}


@pytest.mark.parametrize("case", list(TREES))
def test_fresh_tree_matches_jax_init(case):
    """``bridge.init_params`` gives JAX's ``model.init`` tree leaf for leaf: the same
    paths (params and batch statistics) and the same shapes; conv biases 0, BatchNorm
    1/0 with running statistics 0/1, conv kernels lecun-normal over every axis but the
    last (a depthwise kernel's fan-in is 9)."""
    from tpuhar.models.crossmodal import FusionClassifier as JaxFusion
    from tpuhar.models.crossmodal import IMUClassifier as JaxIMU

    kind, backbone, encoder, featurizer = TREES[case]
    cfg = _jax_config(backbone, encoder, featurizer)
    cfg.data.video_resize, cfg.data.video_frames_per_window = (64, 64), 4
    imu = jax.ShapeDtypeStruct((2, 6, 250), jnp.float32)
    if kind == "fusion":
        video = jax.ShapeDtypeStruct((2, 4, 64, 64, 3), jnp.float32)
        shapes = jax.eval_shape(lambda i, v: JaxFusion(cfg).init(jax.random.PRNGKey(0), i, v), imu, video)
    else:
        shapes = jax.eval_shape(lambda i: JaxIMU(cfg).init(jax.random.PRNGKey(0), i), imu)
    ours = init_params(cfg, torch.Generator().manual_seed(0), FusionClassifier if kind == "fusion" else IMUClassifier)
    for col in ("params", "batch_stats"):
        assert _tree_shapes(ours[col]) == _tree_shapes(shapes.get(col, {})), col
    flat = _flat(ours["params"])
    for name, v in flat.items():
        if name.endswith("_bn/bias") or ("conv" in name and name.endswith("/bias")):
            assert not v.any(), name
    for name, v in _flat(ours["batch_stats"]).items():
        assert np.all(v == (1.0 if name.endswith("var") else 0.0)), name
    if backbone == "mobilenet_v2":
        dw = flat["video_encoder/backbone/ir16/dw_conv/kernel"]  # (3, 3, 1, 960)
        assert dw.shape == (3, 3, 1, 960) and abs(dw.std() * 3.0 - 1.0) < 0.05
    if encoder == "cnn":
        k = flat["imu_encoder/conv1/kernel"]  # (9, 64, 128): fan-in 576
        assert k.shape == (9, 64, 128) and abs(k.std() * np.sqrt(576) - 1.0) < 0.05
    if featurizer == "stft":
        k = flat["imu_encoder/stft_tokenizer/kernel"]
        assert k.shape == (6, 33, 128) and abs(k.std() * np.sqrt(6 * 33) - 1.0) < 0.05
        pos = flat["imu_encoder/pos_encoding"]
        assert pos.shape == (1, 37, 128) and abs(pos.std() - 0.02) < 2e-3


def test_every_backbone_builds_in_train_and_eval():
    """``build_video_encoder`` takes every name of ``CNN_FEATURE_DIMS`` and
    ``VIT_CONFIGS``; an unknown name raises as the JAX package's does."""
    from tpuhar_torch.config import Config
    from tpuhar_torch.models.video import VIT_CONFIGS

    cfg = Config()
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 2
    cfg.model.video_d_model = 16
    clip = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, 32, 32, 3)).astype(np.float32))
    for backbone in [*CNN_FEATURE_DIMS, "videomae_tiny"]:
        cfg.model.video_backbone = backbone
        enc = build_video_encoder(cfg, torch.float32)
        if backbone in CNN_FEATURE_DIMS:
            assert enc.projection.in_features == CNN_FEATURE_DIMS[backbone]
        variables = init_params(cfg, torch.Generator().manual_seed(0), FusionClassifier)
        load_variables(enc, {k: v["video_encoder"] for k, v in variables.items() if "video_encoder" in v})
        for train in (True, False):
            with torch.no_grad():
                emb, tokens = enc(clip, train=train)
            assert emb.shape == (1, 16) and torch.isfinite(tokens).all(), (backbone, train)
    with torch.device("meta"):
        for backbone in VIT_CONFIGS:
            cfg.model.video_backbone = backbone
            assert build_video_encoder(cfg, torch.float32).is_vit
    cfg.model.video_backbone = "vgg16"
    with pytest.raises(ValueError, match="Unknown video backbone"):
        build_video_encoder(cfg, torch.float32)


def test_tiny_cnn_fusion_engine_matches_jax():
    """The fusion engine with the ``tiny_cnn`` tower (the clip normalized on the device:
    nothing folds into a padded conv) on ``device="cpu"``, against the JAX package's
    engine on the same variables and raw inputs, at batch sizes 4 (a padded request of
    3 and a chunked one of 6)."""
    from tpuhar.models.crossmodal import FusionClassifier as JaxFusion
    from tpuhar.serving import InferenceEngine as JaxEngine

    cfg = _jax_config("tiny_cnn")
    cfg.model.imu_d_model, cfg.model.imu_nhead, cfg.model.imu_num_layers = 32, 4, 2
    cfg.model.fusion_heads, cfg.model.num_classes, cfg.model.video_d_model = 4, 5, 64
    cfg.model.head_norm = "layer"
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 4
    rng = np.random.default_rng(5)
    imu = rng.normal(0, 8000.0, (6, 250, 6)).astype(np.float32)
    clip = rng.integers(0, 256, (6, 4, 32, 32, 3), dtype=np.uint8)
    variables = jax.device_get(JaxFusion(cfg).init(
        jax.random.PRNGKey(0), np.zeros((1, 6, 250), np.float32), np.zeros((1, 4, 32, 32, 3), np.float32)))
    variables = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    ours = InferenceEngine(cfg, variables, batch_sizes=[4], device="cpu")
    theirs = JaxEngine(cfg, variables, batch_sizes=[4])
    assert not ours.folded and not ours.patch_major
    before = kernel_launches()
    for n in (3, 6):
        got, want = ours.predict(imu[:n], clip[:n]), theirs.predict(imu[:n], clip[:n])
        for key in ("logits", "msp", "energy", "embeddings"):
            w = np.asarray(want[key])
            assert got[key].shape == w.shape, key
            np.testing.assert_allclose(got[key], w, rtol=0, atol=OUT_RTOL * np.abs(w).max(), err_msg=key)
        assert np.array_equal(got["preds"], np.asarray(want["preds"]))
    assert kernel_launches() == before  # CPU tensors launch nothing
