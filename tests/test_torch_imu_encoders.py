"""The port's IMU 1-D CNN and STFT spectrogram encoders, and ``stft_featurize``, against
the JAX package's, on the same parameters and windows; and the IMU-only engine with the
1-D CNN against ``tpuhar.serving.InferenceEngine``.

Sizes: the configuration's windows (T=250, 6 channels), encoders at d=32, 2 layers and
4 heads, dropout 0 (so that the two frameworks' random streams cannot matter), the 1-D
CNN at the configuration's widths (64, 128, 128) and kernel 9, 4 windows of standard
normal samples, f32. JAX's ``init`` draws the parameters, the port loads them through
``bridge``.

Tolerances:

- the encoders, in eval and in train mode: the embedding and the tokens within 1e-5 of
  the output's largest element; the 1-D CNN's moved running statistics 1e-5 absolute;
- ``stft_featurize``: the log-magnitudes within 1e-5 absolute wherever the magnitude is
  at least 1, and every magnitude within 1e-5 of the largest. An f32 FFT's error is a
  share of the frame's energy, not of each bin's magnitude, so a bin of magnitude 0.01
  carries a log error a hundred times that of a bin of magnitude 1, in either package;
- the engine: logits, MSP, energy and embeddings within 1e-5 of their largest element,
  the predictions exactly.
"""
import jax
import numpy as np
import pytest
import torch

from tpuhar.ops.featurize import stft_featurize as jax_stft_featurize
from tpuhar_torch.bridge import _flatten, load_variables, variables_to_numpy
from tpuhar_torch.models.imu import IMUConvEncoder, IMUSpectrogramEncoder, IMUTransformerEncoder, build_imu_encoder
from tpuhar_torch.ops.featurize import stft_featurize
from tpuhar_torch.serving import InferenceEngine, kernel_launches

torch.set_num_threads(2)

OUT_RTOL = 1e-5
STATS_ATOL = 1e-5
LOG_ATOL = 1e-5
MAG_RTOL = 1e-5


def _config(encoder: str):
    """The JAX package's configuration with the IMU encoder ``encoder`` ("cnn",
    "stft" or "transformer") cut to test size."""
    from tpuhar.config import Config

    cfg = Config()
    m = cfg.model
    m.imu_encoder = "cnn" if encoder == "cnn" else "transformer"
    cfg.data.imu_featurizer = "stft" if encoder == "stft" else "raw"
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 32, 4, 2
    m.imu_dropout = m.classifier_dropout = 0.0
    m.num_classes, m.classifier_hidden_dims, m.head_norm = 5, [32, 16], "layer"
    m.compute_dtype = "float32"
    return cfg


def _windows(seed: int, n: int = 4):
    return np.random.default_rng(seed).standard_normal((n, 250, 6)).astype(np.float32)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in _flatten(tree)}


def _spectrum_errors(got, want):
    """(largest log error where the magnitude is at least 1, largest magnitude error
    over the largest magnitude)."""
    mag_got, mag_want = np.exp(got.astype(np.float64)) - 1e-6, np.exp(want.astype(np.float64)) - 1e-6
    strong = mag_want >= 1.0
    return np.abs(got - want)[strong].max(), np.abs(mag_got - mag_want).max() / mag_want.max()


@pytest.mark.parametrize("nperseg,hop", [(64, 32), (32, 16), (50, 25)])
def test_stft_featurize_matches_jax(nperseg, hop):
    x = _windows(nperseg)
    want = np.asarray(jax_stft_featurize(x, nperseg=nperseg, hop=hop))
    got = stft_featurize(torch.from_numpy(x), nperseg=nperseg, hop=hop).numpy()
    frames = (250 - nperseg) // hop + 1
    assert got.shape == want.shape == (4, 6, frames, nperseg // 2 + 1) and got.dtype == np.float32
    log_err, mag_err = _spectrum_errors(got, want)
    assert log_err <= LOG_ATOL and mag_err <= MAG_RTOL, (log_err, mag_err)


def test_a_periodic_window_fails_the_comparison():
    """torch's default Hann window is the periodic one; numpy's (``jnp.hanning``) is the
    symmetric one. With the periodic window the same comparison fails."""
    x = torch.from_numpy(_windows(0))
    want = np.asarray(jax_stft_featurize(x.numpy()))
    frames = x.unfold(-2, 64, 32)
    periodic = torch.log(torch.fft.rfft(frames * torch.hann_window(64), dim=-1).abs() + 1e-6).transpose(-3, -2)
    log_err, mag_err = _spectrum_errors(periodic.numpy(), want)
    assert log_err > 100 * LOG_ATOL and mag_err > 100 * MAG_RTOL


def test_build_imu_encoder_keys_as_jax():
    """``cnn`` first, then the ``stft`` featurizer, else the raw-patch transformer."""
    from tpuhar_torch.config import Config

    cfg = Config()
    with torch.device("meta"):
        assert isinstance(build_imu_encoder(cfg, torch.float32), IMUTransformerEncoder)
        cfg.data.imu_featurizer = "stft"
        assert isinstance(build_imu_encoder(cfg, torch.float32), IMUSpectrogramEncoder)
        cfg.model.imu_encoder = "cnn"
        assert isinstance(build_imu_encoder(cfg, torch.float32), IMUConvEncoder)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("encoder", ["cnn", "stft"])
def test_imu_encoder_matches_jax(encoder, train):
    from tpuhar.models.imu import build_imu_encoder as jax_build_imu_encoder

    cfg = _config(encoder)
    x = np.swapaxes(_windows(len(encoder)), 1, 2)  # (B, C, T) featurized windows
    jmodel = jax_build_imu_encoder(cfg)
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x))
    variables = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    port = load_variables(build_imu_encoder(cfg, torch.float32), variables)
    with torch.no_grad():
        emb, tokens = port(torch.from_numpy(x), train=train)
    if train:
        (jemb, jtokens), updated = jax.jit(
            lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(variables, x)
    else:
        jemb, jtokens = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x)
    tokens_n = 32 if encoder == "cnn" else 37  # 250 → 125 → 63 → 32 frames; 1 + 6·6 tokens
    assert tuple(emb.shape) == (4, 32) and tuple(tokens.shape) == (4, tokens_n, 32)
    for got, want in ((emb, jemb), (tokens, jtokens)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_RTOL * np.abs(want).max())
    stats = _flat(variables_to_numpy(port)["batch_stats"])
    want_stats = _flat(jax.device_get(updated["batch_stats"])) if train else _flat(variables["batch_stats"])
    assert stats.keys() == want_stats.keys() and (encoder == "stft") == (not stats)
    for name, w in want_stats.items():
        np.testing.assert_allclose(stats[name], w, rtol=0, atol=STATS_ATOL if train else 0, err_msg=name)


def test_cnn_imu_engine_matches_jax():
    """The IMU-only engine with the 1-D CNN encoder on ``device="cpu"`` against the JAX
    package's engine on the same variables and raw counts, at batch sizes 4 and 8 (a
    padded request of 5 and a chunked one of 11)."""
    from tpuhar.models.crossmodal import IMUClassifier as JaxIMU
    from tpuhar.serving import InferenceEngine as JaxEngine

    cfg = _config("cnn")
    variables = jax.device_get(JaxIMU(cfg).init(jax.random.PRNGKey(0), np.zeros((1, 6, 250), np.float32)))
    variables = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    assert "imu_encoder" in variables["batch_stats"]
    ours = InferenceEngine(cfg, variables, imu_only=True, batch_sizes=[4, 8], device="cpu")
    theirs = JaxEngine(cfg, variables, imu_only=True, batch_sizes=[4, 8])
    raw = np.random.default_rng(9).normal(0, 8000.0, (11, 250, 6)).astype(np.float32)
    before = kernel_launches()
    for n in (5, 11):
        got, want = ours.predict(raw[:n]), theirs.predict(raw[:n])
        for key in ("logits", "msp", "energy", "embeddings"):
            w = np.asarray(want[key])
            assert got[key].shape == w.shape, key
            np.testing.assert_allclose(got[key], w, rtol=0, atol=OUT_RTOL * np.abs(w).max(), err_msg=key)
        assert np.array_equal(got["preds"], np.asarray(want["preds"]))
    assert kernel_launches() == before  # CPU tensors launch nothing
