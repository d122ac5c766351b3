"""The port's preprocessor (``tpuhar_torch/data/preprocess.py``) and frame-bank writer
(``data/frames.FrameBankWriter``) against the JAX package's, on the CPU.

The synthetic dataset of ``tests/conftest.py`` is preprocessed once for the module by
both packages along each featurize route: ``"device"`` (the default; the port's
``Preprocessor(device="cpu")`` runs the batched ``preprocess_sequence``, JAX its vmapped
jit), ``"host"`` (numpy and scipy on both sides) and ``zscore_scope="window"`` (the
port's ``featurize_windows_auto`` on CPU tensors, i.e. its plain version, against JAX's
``featurize_windows``). Held:

- the metadata CSVs column for column (``imu_window_path`` relative to each output
  root, the only place the two roots show);
- every window ``.npy`` and ``{split}_windows.npy``: bit for bit on the host route,
  within 1e-5 absolute on the others (unit-variance f32 outputs; the sums' order
  differs);
- ``preprocessing_stats.json`` equal; ``data_fingerprint.json`` equal on the host route
  (the fingerprint hashes the window bank's bytes), and the port's ``data_fingerprint``
  equal to JAX's on the same directory on every route;
- the frame bank, its index and its sidecar byte for byte (both write through OpenCV);
- with ``max_sequence_length`` forced below the sequences, the truncation counter, the
  warning and the windows.
"""
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_data import port_config

from tpuhar_torch.data import preprocess as pp

torch.set_num_threads(2)

ATOL = 1e-5
SPLITS = ("train", "val", "test")
ROUTES = {
    "device": {"extract_frames": True},
    "host": {"featurize_backend": "host", "extract_frames": False},
    "window": {"zscore_scope": "window", "extract_frames": False},
}


def _configs(synthetic_dataset, root: Path, name: str, **data):
    """``(jax config, port config)`` on the dataset, each writing under its own root."""
    from tpuhar.data.synthetic import make_synthetic_config

    jcfg = make_synthetic_config(synthetic_dataset, root / f"jax_{name}")
    for key, value in data.items():
        setattr(jcfg.data, key, value)
    cfg = port_config(jcfg)
    cfg.paths.base_output = root / f"port_{name}"
    cfg.paths.__post_init__()
    return jcfg, cfg


@pytest.fixture(scope="module")
def runs(synthetic_dataset, tmp_path_factory):
    """``{route: (jax config, port config, jax dfs, port dfs)}``, each preprocessed once."""
    from tpuhar.data.preprocess import Preprocessor as JPreprocessor

    root = tmp_path_factory.mktemp("preprocess")
    out = {}
    for route, data in ROUTES.items():
        jcfg, cfg = _configs(synthetic_dataset, root, route, **data)
        out[route] = (jcfg, cfg, JPreprocessor(jcfg).run_full_preprocessing(),
                      pp.Preprocessor(cfg, device="cpu").run_full_preprocessing())
    return out


def _relative(df: pd.DataFrame, root) -> pd.DataFrame:
    df = df.copy()
    df["imu_window_path"] = [str(Path(p).relative_to(root)) for p in df["imu_window_path"]]
    return df


@pytest.mark.parametrize("route", ROUTES)
def test_metadata_csvs_match_jax(runs, route):
    jcfg, cfg, jdfs, dfs = runs[route]
    for split in SPLITS:
        mine = pd.read_csv(Path(cfg.paths.preprocessed_dir) / f"{split}_metadata.csv")
        theirs = pd.read_csv(Path(jcfg.paths.preprocessed_dir) / f"{split}_metadata.csv")
        assert list(mine.columns) == list(theirs.columns) and len(mine) > 0
        pd.testing.assert_frame_equal(_relative(mine, cfg.paths.base_output), _relative(theirs, jcfg.paths.base_output))
        pd.testing.assert_frame_equal(_relative(dfs[split], cfg.paths.base_output),
                                      _relative(jdfs[split], jcfg.paths.base_output))


@pytest.mark.parametrize("route", ROUTES)
def test_windows_match_jax(runs, route):
    jcfg, cfg, jdfs, dfs = runs[route]
    check = np.testing.assert_array_equal if route == "host" else \
        (lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=ATOL))
    for split in SPLITS:
        mine = np.load(Path(cfg.paths.preprocessed_dir) / f"{split}_windows.npy")
        theirs = np.load(Path(jcfg.paths.preprocessed_dir) / f"{split}_windows.npy")
        assert mine.shape == theirs.shape == (len(jdfs[split]), 250, 6) and mine.dtype == theirs.dtype == np.float32
        check(mine, theirs)
        for p_mine, p_theirs in zip(dfs[split]["imu_window_path"], jdfs[split]["imu_window_path"]):
            a, b = np.load(p_mine), np.load(p_theirs)
            assert a.shape == b.shape and a.dtype == b.dtype
            check(a, b)


@pytest.mark.parametrize("route", ROUTES)
def test_stats_and_fingerprint_match_jax(runs, route):
    from tpuhar.data.preprocess import data_fingerprint as jax_fingerprint

    jcfg, cfg, _, _ = runs[route]
    mine, theirs = Path(cfg.paths.preprocessed_dir), Path(jcfg.paths.preprocessed_dir)
    stats = json.loads((mine / "preprocessing_stats.json").read_text())
    assert stats == json.loads((theirs / "preprocessing_stats.json").read_text())
    assert stats["total_windows"] > 0 and stats["truncated_sequences"] == 0
    recorded = json.loads((mine / pp.FINGERPRINT_FILENAME).read_text())
    assert sorted(recorded) == list(sorted(SPLITS))
    assert recorded == pp.data_fingerprint(mine)
    assert pp.data_fingerprint(theirs) == jax_fingerprint(theirs)
    if route == "host":
        assert recorded == json.loads((theirs / pp.FINGERPRINT_FILENAME).read_text())


def test_verify_data_fingerprint(runs, tmp_path, capsys):
    _, cfg, _, _ = runs["device"]
    pre = Path(cfg.paths.preprocessed_dir)
    assert pp.verify_data_fingerprint(pre / pp.FINGERPRINT_FILENAME, pre)
    assert pp.verify_data_fingerprint(tmp_path / "none.json", pre, context="legacy")
    assert "WARNING [legacy]: no recorded data fingerprint" in capsys.readouterr().out
    wrong = json.loads((pre / pp.FINGERPRINT_FILENAME).read_text())
    wrong["val"] = "0" * 64
    (tmp_path / "wrong.json").write_text(json.dumps(wrong))
    with pytest.raises(RuntimeError, match=r"fingerprint mismatch \[ctx\]: splits \['val'\]"):
        pp.verify_data_fingerprint(tmp_path / "wrong.json", pre, context="ctx")


def test_frame_banks_match_jax_byte_for_byte(runs):
    jcfg, cfg, jdfs, _ = runs["device"]
    mine, theirs = Path(cfg.paths.preprocessed_dir), Path(jcfg.paths.preprocessed_dir)
    for split in SPLITS:
        blob = (mine / f"{split}_frames.bin").read_bytes()
        assert len(blob) > 0 and blob == (theirs / f"{split}_frames.bin").read_bytes()
        assert (mine / f"{split}_frame_index.npy").read_bytes() == (theirs / f"{split}_frame_index.npy").read_bytes()
        assert (mine / f"{split}_frame_index.meta.json").read_text() == \
            (theirs / f"{split}_frame_index.meta.json").read_text()
        assert np.load(mine / f"{split}_frame_index.npy").shape == (len(jdfs[split]), jcfg.data.video_frames_per_window, 2)


def test_frame_bank_writer_missing_and_empty(tmp_path):
    from tpuhar.data.frames import FrameBankWriter as JWriter

    from tpuhar_torch.data.frames import FrameBankReader, FrameBankWriter

    tables = []
    for name, cls in (("mine", FrameBankWriter), ("theirs", JWriter)):
        w = cls(tmp_path / f"{name}.bin", num_frames=4, resize_hw=(32, 32))
        w.add_missing(2)
        w.add_video(tmp_path / "absent.mp4", [0, 10], window_seconds=5.0, fallback_fps=25.0)
        tables.append(w.finalize(tmp_path / f"{name}_index.npy"))
        empty = cls(tmp_path / f"{name}_empty.bin", num_frames=4, resize_hw=(32, 32))
        assert empty.finalize(tmp_path / f"{name}_empty_index.npy") is None
        assert not (tmp_path / f"{name}_empty.bin").exists()
    np.testing.assert_array_equal(tables[0], tables[1])
    assert tables[0].shape == (4, 4, 2) and (tables[0] == -1).all()
    reader = FrameBankReader(tmp_path / "mine.bin", tmp_path / "mine_index.npy")
    assert not reader.legacy_color and not reader.has_frames(0)
    reader.close()


def test_truncation_counter_and_windows_match_jax(synthetic_dataset, tmp_path, capsys):
    """``max_sequence_length`` 256 under the dataset's 300-700 samples: every sequence is
    cut to its first 256 samples on the device route, counted and warned about, as in
    the JAX package; the windows of the cut sequences agree."""
    from tpuhar.data.preprocess import Preprocessor as JPreprocessor

    jcfg, cfg = _configs(synthetic_dataset, tmp_path, "cap", max_sequence_length=256, extract_frames=False)
    jp, mine = JPreprocessor(jcfg), pp.Preprocessor(cfg, device="cpu")
    jdf, df = jp.preprocess_split("train", save=False), mine.preprocess_split("train", save=False)
    out = capsys.readouterr().out
    pd.testing.assert_frame_equal(df, jdf)
    assert mine.preprocessing_stats == jp.preprocessing_stats
    n = mine.preprocessing_stats["truncated_sequences"]
    assert n == mine.preprocessing_stats["total_samples"] > 0
    assert out.count("truncated to 256 on the device path") == 2 * n  # once per package
    raws = [mine.load_raw_imu(f"sensor/0_activity0/0_activity0_train_{i}.csv") for i in range(3)]
    for a, b in zip(mine.make_windows_batch(raws), jp.make_windows_batch(raws)):
        assert len(a) == len(b) == 1
        np.testing.assert_allclose(np.stack(a), np.stack(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("route", ROUTES)
def test_resampled_windows_match_jax(synthetic_dataset, tmp_path, route):
    """``imu_original_rate`` 100 against the 50 Hz target: every route resamples first
    (``fourier_resample`` on the preprocessor's device, scipy on the host route), short
    sequences are padded to a window; ``make_windows`` and ``make_windows_batch``."""
    from tpuhar.data.preprocess import Preprocessor as JPreprocessor

    data = {k: v for k, v in ROUTES[route].items() if k != "extract_frames"}
    jcfg, cfg = _configs(synthetic_dataset, tmp_path, route, imu_original_rate=100, **data)
    jp, mine = JPreprocessor(jcfg), pp.Preprocessor(cfg, device="cpu")
    raws = [np.random.default_rng(n).normal(0, 8000, (n, 6)).astype(np.float32) for n in (901, 400, 120)]
    atol = 1e-4 if route == "host" else ATOL  # scipy's float64 resample rounded to f32 on both sides
    for a, b in zip(mine.make_windows_batch(raws), jp.make_windows_batch(raws)):
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(np.stack(a), np.stack(b), rtol=0, atol=atol)
    np.testing.assert_allclose(np.stack(mine.make_windows(raws[0])), np.stack(jp.make_windows(raws[0])), rtol=0,
                               atol=atol)
    cfg.data.pad_short_sequences = jcfg.data.pad_short_sequences = False  # 200 and 60 samples at 50 Hz
    assert [len(w) for w in mine.make_windows_batch(raws)] == [len(w) for w in jp.make_windows_batch(raws)] == [2, 0, 0]
    assert mine.preprocessing_stats["too_short_no_pad"] == jp.preprocessing_stats["too_short_no_pad"] == 2


def test_window_route_hands_the_kernel_a_window_it_takes(runs, monkeypatch):
    """The window route's chunks pass the fused kernel's operand check (a contiguous f32
    ``(B, T, 6)``): a sensor CSV's values come column-major out of pandas, and a chunk
    stacked from their slices is not C-ordered unless the preprocessor makes it so."""
    from tpuhar_torch.ops import fused_window

    _, cfg, _, _ = runs["window"]
    real, seen = pp.featurize_windows_auto, []

    def checked(x, *, kernel_size, **kw):
        fused_window.check_fused_window_operand(x.shape, x.dtype, x.is_contiguous(), kernel_size)
        seen.append(x.shape[0])
        return real(x, kernel_size=kernel_size, **kw)

    monkeypatch.setattr(pp, "featurize_windows_auto", checked)
    mine = pp.Preprocessor(cfg, device="cpu")
    raw = mine.load_raw_imu("sensor/1_activity1/1_activity1_val_0.csv")
    assert not raw.flags.c_contiguous
    windows = mine.make_windows_batch([raw, raw[10:]])  # slices of column-major arrays only
    assert len(windows[0]) > 1 and seen == [len(windows[0]) + len(windows[1])]
    assert len(mine.make_windows_batch([raw[:100]])[0]) == 1 and seen[-1] == 1  # zero-padded to a window


def test_bucket_length_alias_and_device():
    from tpuhar.data import preprocess as jpp

    for n, window, cap in ((10, 250, 16384), (256, 250, 16384), (257, 250, 16384), (5000, 250, 16384),
                           (5000, 250, 1000), (300, 512, 16384), (40000, 250, 16384)):
        assert pp._bucket_length(n, window, cap) == jpp._bucket_length(n, window, cap)
    assert pp.MMEAPreprocessor is pp.Preprocessor
    assert pp.FINGERPRINT_FILENAME == jpp.FINGERPRINT_FILENAME


def test_preprocessor_on_cuda_needs_a_card(monkeypatch, synthetic_config):
    from tpuhar_torch.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="Preprocessor on 'cuda' needs a CUDA device"):
        pp.Preprocessor(Config())
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        pp.Preprocessor(Config(), device="meta")
