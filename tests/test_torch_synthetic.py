"""The port's synthetic dataset generator (``tpuhar_torch/data/synthetic.py``) and raw
serving stream (``data/raw_stream.py``) against the JAX package's, on the CPU.

- The generator with the same arguments into two directories: the sensor CSVs and the
  split files byte for byte (the same numpy draws in the same order, the same
  ``savetxt``), the videos decoding to equal frames (both written by OpenCV's
  ``VideoWriter``, ``mp4v``), on the easy and the hard variant with label noise and the
  cross-modal pulse; ``make_synthetic_config``'s fields equal.
- ``RawWindowReader`` and ``raw_serving_stream`` (IMU-only and with clips decoded from
  the frame banks) over a manifest the JAX package's preprocessor wrote: every batch
  equal, with ``max_windows``.
"""
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from tpuhar_torch.data import raw_stream as prs
from tpuhar_torch.data import synthetic as psyn

torch.set_num_threads(2)

VARIANTS = {
    "easy": dict(num_classes=3, samples_per_class=2, seed=5),
    "hard": dict(num_classes=4, samples_per_class=2, seed=1, difficulty="hard", label_noise=0.5,
                 cross_modal_coupling=True, coupling_strength=2.0, video_size=(48, 32), seq_len=260),
}


def _frames(path: Path) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("variant", VARIANTS)
def test_generator_matches_jax(tmp_path, variant):
    from tpuhar.data.synthetic import generate_synthetic_dataset as jax_generate

    kw = VARIANTS[variant]
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    assert psyn.generate_synthetic_dataset(mine, **kw) == mine
    jax_generate(theirs, **kw)
    files = sorted(p.relative_to(theirs) for p in theirs.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(mine) for p in mine.rglob("*") if p.is_file())
    videos = [f for f in files if f.suffix == ".mp4"]
    assert len(videos) == 3 * kw["num_classes"] * kw["samples_per_class"]
    for f in files:
        if f.suffix == ".mp4":
            a, b = _frames(mine / f), _frames(theirs / f)
            assert a.shape == b.shape and len(a) >= 8
            np.testing.assert_array_equal(a, b, err_msg=str(f))
        else:
            assert (mine / f).read_bytes() == (theirs / f).read_bytes(), f


def test_generator_without_video_and_bad_difficulty(tmp_path):
    from tpuhar.data.synthetic import generate_synthetic_dataset as jax_generate

    psyn.generate_synthetic_dataset(tmp_path / "mine", with_video=False, splits=("train",), seed=3)
    jax_generate(tmp_path / "theirs", with_video=False, splits=("train",), seed=3)
    assert not (tmp_path / "mine" / "video").exists()
    assert (tmp_path / "mine" / "train.txt").read_bytes() == (tmp_path / "theirs" / "train.txt").read_bytes()
    with pytest.raises(ValueError, match="difficulty"):
        psyn.generate_synthetic_dataset(tmp_path / "x", difficulty="medium")


def test_make_synthetic_config_matches_jax(tmp_path):
    from tpuhar.data.synthetic import make_synthetic_config as jax_config

    kw = dict(num_classes=5, few_shot_runs=3, **{"training.seed": 9, "data.imu_stride": 50})
    mine = psyn.make_synthetic_config(tmp_path / "data", tmp_path / "out", **dict(kw))
    theirs = jax_config(tmp_path / "data", tmp_path / "out", **dict(kw))
    assert type(mine).__module__ == "tpuhar_torch.config"
    assert mine.to_dict() == theirs.to_dict()
    assert Path(mine.paths.results_dir).is_dir()
    with pytest.raises(ValueError, match="Unknown override"):
        psyn.make_synthetic_config(tmp_path / "data", tmp_path / "out", bogus=1)


@pytest.fixture(scope="module")
def manifest(synthetic_dataset, tmp_path_factory):
    """The JAX package's preprocessed test split of the conftest dataset (frame banks
    included), and ``(jax config, port config)``."""
    from test_torch_data import port_config

    from tpuhar.data.preprocess import Preprocessor
    from tpuhar.data.synthetic import make_synthetic_config

    jcfg = make_synthetic_config(synthetic_dataset, tmp_path_factory.mktemp("raw") / "outputs")
    jcfg.data.featurize_backend = "host"
    jcfg.data.video_frames_per_window = 4
    df = Preprocessor(jcfg).preprocess_split("test", save=True)
    return df, jcfg, port_config(jcfg)


def test_raw_window_reader_matches_jax(manifest):
    from tpuhar.data.raw_stream import RawWindowReader as JReader

    df, jcfg, cfg = manifest
    mine, theirs = prs.RawWindowReader(cfg), JReader(jcfg)
    for row in df.itertuples():
        a, b = mine.window(row), theirs.window(row)
        assert a.shape == (250, 6) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert len(mine._cache) == df["sensor_path"].nunique()
    short = pd.DataFrame({"sensor_path": [df["sensor_path"][0]], "window_idx": [100]})  # past the end: zeros
    row = next(short.itertuples())
    np.testing.assert_array_equal(mine.window(row), theirs.window(row))


@pytest.mark.parametrize("with_video,batch,max_windows", [(False, 8, None), (False, 5, 12), (True, 8, None),
                                                           (True, 8, 9)])
def test_raw_serving_stream_matches_jax(manifest, with_video, batch, max_windows):
    from tpuhar.data.raw_stream import raw_serving_stream as jax_stream

    df, jcfg, cfg = manifest
    kw = dict(batch_size=batch, with_video=with_video, max_windows=max_windows)
    mine, theirs = list(prs.raw_serving_stream(cfg, df, **kw)), list(jax_stream(jcfg, df, **kw))
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert len(a) == len(b) == (2 if with_video else 1)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    served = sum(len(t[0]) for t in mine)
    want = len(df) if max_windows is None else min(len(df), -(-max_windows // batch) * batch)
    assert served == want
    if with_video:
        assert mine[0][1].shape[1:] == (4, 64, 64, 3) and mine[0][1].any()
