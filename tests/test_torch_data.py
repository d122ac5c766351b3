"""The port's data layer (``tpuhar_torch/data/``) against the JAX package's
(``tpuhar/data/``), on the CPU.

The synthetic dataset of ``tests/conftest.py`` (4 classes, 64² clips) is preprocessed
once for this module by the JAX package's ``Preprocessor`` (window banks, frame banks,
manifests). The manifest functions, ``FewShotSampler``'s rows and the loaders' batches
are held to the JAX package's bit for bit: the loaders in all three modes, from the
banks and from one file per window and one decode per clip, shuffled per epoch, with
``drop_last`` and with the padded last batch's ``n_valid``. The JAX frame bank reader
is read through its OpenCV path (``backend="cv2"``), the one the port has.
"""
import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from tpuhar_torch.config import Config
from tpuhar_torch.data import loader as pl
from tpuhar_torch.data import manifest as pm
from tpuhar_torch.data.frames import FrameBankReader


@pytest.fixture(scope="module")
def prepared(synthetic_dataset, tmp_path_factory):
    """``(jax config, port config, {split: manifest})``, preprocessed once."""
    from tpuhar.data.preprocess import Preprocessor
    from tpuhar.data.synthetic import make_synthetic_config

    jcfg = make_synthetic_config(synthetic_dataset, tmp_path_factory.mktemp("data") / "outputs")
    dfs = {s: Preprocessor(jcfg).preprocess_split(s, save=True) for s in ("train", "val", "test")}
    return jcfg, port_config(jcfg), dfs


def port_config(jcfg):
    """The port's ``Config`` with every field of the JAX package's ``jcfg``."""
    cfg = Config()
    for section in ("model", "training", "data", "eval", "ood"):
        for key, value in vars(getattr(jcfg, section)).items():
            setattr(getattr(cfg, section), key, value)
    for key, value in vars(jcfg.paths).items():
        setattr(cfg.paths, key, value)
    return cfg


def assert_batches_equal(mine, theirs):
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            x, y = a[k], b[k]
            if isinstance(x, list):
                assert x == y, k
            else:
                assert np.asarray(x).dtype == np.asarray(y).dtype, k
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)


# ---------------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------------
def test_split_lines_parse_as_jax(prepared):
    from tpuhar.data import manifest as jm

    jcfg, cfg, _ = prepared
    assert pm.METADATA_COLUMNS == jm.METADATA_COLUMNS
    for split in ("train", "val", "test"):
        lines = pm.load_split_lines(cfg, split)
        assert lines == jm.load_split_lines(jcfg, split)
        for line in lines:
            assert dataclasses.asdict(pm.parse_split_line(line)) == dataclasses.asdict(jm.parse_split_line(line))
    swapped = "x/data/3_walk/s01 90 10 3"  # reversed span, numeric class prefix
    assert dataclasses.asdict(pm.parse_split_line(swapped)) == dataclasses.asdict(jm.parse_split_line(swapped))
    named = "x/data/walk/s01 1 2 0"
    assert pm.parse_split_line(named).class_num == jm.parse_split_line(named).class_num == -1
    for bad in ("too few tokens", "x/nodata/c/s 1 2 3", "x/data/c 1 2 3"):
        with pytest.raises(pm.SplitLineError):
            pm.parse_split_line(bad)
        with pytest.raises(jm.SplitLineError):
            jm.parse_split_line(bad)
    with pytest.raises(ValueError, match="Unknown split"):
        pm.load_split_lines(cfg, "dev")


def test_window_records_and_start_frames_match_jax():
    from tpuhar.data import manifest as jm

    for args in ((0, 125, 50, 30.0), (7, 125, 50, 29.97), (13, 100, 50, 25.0)):
        assert pm.estimate_start_frame(*args) == jm.estimate_start_frame(*args)
    line = "root/data/1_run/s07 5 900 1"
    mi, ji = pm.parse_split_line(line), jm.parse_split_line(line)
    for path in (None, "train/1_run/s07_w3.npy"):
        assert pm.window_record("train", mi, line, 3, True, (250, 6), 45, path) == jm.window_record(
            "train", ji, line, 3, True, (250, 6), 45, path
        )


@pytest.mark.parametrize("seed", [None, 0, 42, 43, 46])
@pytest.mark.parametrize("k", [2, 5, 100])
def test_few_shot_sampler_rows_match_jax(prepared, k, seed):
    from tpuhar.data.manifest import FewShotSampler

    _, _, dfs = prepared
    if seed is None:  # unseeded draws differ; the row count must not
        assert len(pm.FewShotSampler(dfs["train"]).sample_k_per_class(k)) == len(
            FewShotSampler(dfs["train"]).sample_k_per_class(k))
        return
    pd.testing.assert_frame_equal(
        pm.FewShotSampler(dfs["train"]).sample_k_per_class(k, seed=seed),
        FewShotSampler(dfs["train"]).sample_k_per_class(k, seed=seed),
    )


def test_class_weights_match_jax(prepared):
    from tpuhar.data.manifest import get_class_weights

    for df in prepared[2].values():
        np.testing.assert_array_equal(pm.get_class_weights(df), get_class_weights(df))


# ---------------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------------
def _both(prepared, split, *, banks=True, epochs=(0,), **kw):
    """The batches of every epoch in ``epochs`` from the port's loader and the JAX
    package's, on the same manifest (without its bank columns when ``banks`` is off)."""
    from tpuhar.data import frames as jframes
    from tpuhar.data.loader import BatchLoader

    jcfg, cfg, dfs = prepared
    df = dfs[split] if banks else dfs[split].drop(columns=["bank_idx"])
    mine, theirs = pl.BatchLoader(df, cfg, **kw), BatchLoader(df, jcfg, **kw)
    read_clip = jframes.FrameBankReader.read_clip
    jframes.FrameBankReader.read_clip = lambda self, row, hw, backend="auto", threads=1: read_clip(
        self, row, hw, backend="cv2")  # the JAX reader's OpenCV path, the one the port has
    try:
        out_m, out_t = [], []
        for epoch in epochs:
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            out_m += list(mine)
            out_t += list(theirs)
    finally:
        jframes.FrameBankReader.read_clip = read_clip
    assert len(mine) == len(theirs)
    return out_m, out_t


@pytest.mark.parametrize("mode", ["classification", "cross_modal", "fusion"])
@pytest.mark.parametrize("banks", [True, False], ids=["banks", "files"])
def test_eval_batches_match_jax(prepared, mode, banks):
    """Unshuffled eval loaders: the last batch zero-padded, ``n_valid`` its real rows."""
    mine, theirs = _both(prepared, "val", banks=banks, mode=mode, batch_size=6, prefetch=0, decode_workers=2)
    assert_batches_equal(mine, theirs)
    assert int(mine[-1]["n_valid"]) == len(prepared[2]["val"]) % 6 != 0
    assert not np.asarray(mine[-1]["imu"])[int(mine[-1]["n_valid"]):].any()
    if mode != "classification":
        assert np.asarray(mine[0]["video"]).any()


@pytest.mark.parametrize("mode", ["classification", "fusion"])
def test_train_batches_shuffle_per_epoch_as_jax(prepared, mode):
    """Shuffled train loaders with ``drop_last`` over three epochs (prefetch thread on):
    each epoch's order is the JAX loader's, and the epochs differ."""
    mine, theirs = _both(prepared, "train", epochs=(0, 1, 2), mode=mode, batch_size=8, shuffle=True,
                         drop_last=True, seed=3, prefetch=2)
    assert_batches_equal(mine, theirs)
    per_epoch = len(prepared[2]["train"]) // 8
    assert len(mine) == 3 * per_epoch and all(int(b["n_valid"]) == 8 for b in mine)
    assert not np.array_equal(mine[0]["idx"], mine[per_epoch]["idx"])


def test_return_info_and_device_batches(prepared):
    """``return_info`` passes the class names through as the JAX loader does; with
    ``device`` the loader yields the same batch as tensors (labels int64), ``n_valid`` an
    int."""
    mine, theirs = _both(prepared, "test", mode="classification", batch_size=8, prefetch=0, return_info=True)
    assert_batches_equal(mine, theirs)
    assert mine[-1]["class_name"][-1] is None
    _, cfg, dfs = prepared
    on_device = list(pl.BatchLoader(dfs["test"], cfg, mode="fusion", batch_size=8, device="cpu"))
    for a, b in zip(on_device, pl.BatchLoader(dfs["test"], cfg, mode="fusion", batch_size=8)):
        assert isinstance(a["n_valid"], int) and a["n_valid"] == int(b["n_valid"])
        assert a["label"].dtype == torch.int64 and a["video"].dtype == torch.uint8
        for k in ("imu", "video", "label"):
            np.testing.assert_array_equal(a[k].numpy(), b[k])
        np.testing.assert_array_equal(a["idx"], b["idx"])


def test_create_dataloaders_and_what_is_not_ported(prepared):
    from tpuhar.data.loader import create_dataloaders

    jcfg, cfg, dfs = prepared
    mine = pl.create_dataloaders(cfg, dfs["train"], dfs["val"], dfs["test"], mode="classification")
    theirs = create_dataloaders(jcfg, dfs["train"], dfs["val"], dfs["test"], mode="classification")
    for split in ("train", "val", "test"):
        m, t = mine[split], theirs[split]
        assert (len(m), m.batch_size, m.shuffle, m.drop_last, m.seed) == (len(t), t.batch_size, t.shuffle, t.drop_last, t.seed)
    with pytest.raises(ValueError, match="Unknown mode"):
        pl.create_dataloaders(cfg, dfs["train"], dfs["val"], dfs["test"], mode="video")
    cfg.data.loader_backend = "grain"
    with pytest.raises(NotImplementedError, match="item 8"):
        pl.create_dataloaders(cfg, dfs["train"], dfs["val"], dfs["test"])
    cfg.data.loader_backend = "default"
    with pytest.raises(NotImplementedError, match="item 8"):
        pl.BatchLoader(dfs["val"], cfg, mode="fusion", decode_processes=2)


def test_imu_window_shape_fixing_matches_jax(tmp_path):
    from tpuhar.data.loader import load_imu_window

    rng = np.random.default_rng(0)
    cases = {"ct.npy": (6, 250), "tc.npy": (250, 6), "short.npy": (100, 4), "long.npy": (300, 9), "flat.npy": (250,)}
    for name, shape in cases.items():
        np.save(tmp_path / name, rng.standard_normal(shape).astype(np.float32))
    (tmp_path / "bad.npy").write_bytes(b"not an array")
    for name in [*cases, "bad.npy", "missing.npy"]:
        got = pl.load_imu_window(name, tmp_path, 6, 250)
        assert got.shape == (6, 250)
        np.testing.assert_array_equal(got, load_imu_window(name, tmp_path, 6, 250))


def test_clip_frame_indices_match_jax():
    from tpuhar.data.loader import clip_frame_indices

    for total, fps, start in [(300, 30.0, 0), (300, 30.0, 290), (10, 25.0, 3), (1, 30.0, 0), (500, 29.97, 499), (40, 30.0, -5)]:
        np.testing.assert_array_equal(
            pl.clip_frame_indices(total, fps, start, num_frames=16, window_seconds=5.0),
            clip_frame_indices(total, fps, start, num_frames=16, window_seconds=5.0),
        )


def test_decode_clip_matches_jax(prepared):
    from tpuhar.data.loader import decode_clip

    _, cfg, dfs = prepared
    row = dfs["train"].iloc[3]
    kw = dict(num_frames=16, window_seconds=5.0, fallback_fps=30.0, resize_hw=(48, 40))
    path = cfg.paths.base_input / row["video_path"]
    got = pl.decode_clip(path, int(row["start_frame"]), **kw)
    assert got.shape == (16, 48, 40, 3) and got.any()
    np.testing.assert_array_equal(got, decode_clip(path, int(row["start_frame"]), **kw))
    assert not pl.decode_clip(path.with_suffix(".missing"), 0, **kw).any()


def test_frame_bank_reads_match_jax(prepared):
    from tpuhar.data.frames import FrameBankReader as JReader

    _, cfg, _ = prepared
    base = cfg.paths.preprocessed_dir
    mine = FrameBankReader(base / "val_frames.bin", base / "val_frame_index.npy")
    theirs = JReader(base / "val_frames.bin", base / "val_frame_index.npy")
    assert len(mine) == len(theirs) and mine.legacy_color == theirs.legacy_color is False
    for row in (0, len(mine) // 2, len(mine) - 1):
        assert mine.has_frames(row) == theirs.has_frames(row)
        for hw in ((64, 64), (32, 48)):
            np.testing.assert_array_equal(mine.read_clip(row, hw), theirs.read_clip(row, hw, backend="cv2"))
    with pytest.raises(NotImplementedError, match="item 8"):
        mine.read_clip(0, (64, 64), backend="native")
    mine.close()
    theirs.close()
