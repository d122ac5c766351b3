"""The port's loader backends against the JAX package's, on the CPU: the process-pool
clip decode (``data/parallel_decode.py``, ``tests/test_loader.py:164``), the
``loader_backend="grain"`` loader (``data/grain_loader.py``,
``tests/test_grain_loader.py:32-76``) and the batched libjpeg decoder (``native/``,
``tests/test_native_decode.py:30-71``).

The conftest's synthetic dataset is preprocessed once for the module by the JAX
package's ``Preprocessor`` (window banks, 64² JPEG frame banks). Every comparison is bit
for bit:

- ``BatchLoader(decode_processes=2)``, with the default and the ``"native"`` frame
  backend, equals the JAX package's pooled loader and the port's threaded one;
- ``GrainBatchLoader`` unshuffled (0 and 2 workers) equals the JAX package's
  ``GrainBatchLoader`` and the port's ``BatchLoader``; shuffled, each epoch takes
  ``BatchLoader``'s order (a departure: Grain's own shuffle needs Grain);
- ``decode_jpeg_bank`` and ``FrameBankReader.read_clip(backend="native")`` equal the
  JAX package's native decoder; ``"native"`` raises where the decoder cannot build or
  the stored frames are another size, and never falls back to OpenCV.
"""
import numpy as np
import pytest
import torch

from tpuhar_torch import native
from tpuhar_torch.data import loader as pl
from tpuhar_torch.data.frames import FrameBankReader
from tpuhar_torch.data.grain_loader import GrainBatchLoader

from test_torch_data import assert_batches_equal, port_config

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def prepared(synthetic_dataset, tmp_path_factory):
    """``(jax config, port config, {split: manifest})``, preprocessed once."""
    from tpuhar.data.preprocess import Preprocessor
    from tpuhar.data.synthetic import make_synthetic_config

    jcfg = make_synthetic_config(synthetic_dataset, tmp_path_factory.mktemp("backends") / "outputs")
    jcfg.data.video_frames_per_window = 4
    dfs = {s: Preprocessor(jcfg).preprocess_split(s, save=True) for s in ("train", "val")}
    return jcfg, port_config(jcfg), dfs


@pytest.mark.parametrize("frame_backend", ["auto", "native"])
def test_process_pool_matches_jax_and_threads(prepared, frame_backend):
    from tpuhar.data.loader import BatchLoader as JaxLoader

    jcfg, cfg, dfs = prepared
    df = dfs["train"].head(8)
    kw = dict(mode="cross_modal", batch_size=4, prefetch=0)
    pooled = pl.BatchLoader(df, cfg, decode_processes=2, frame_backend=frame_backend, **kw)
    try:
        got = list(pooled)
        assert pooled._decode_pool is not None and pooled._decode_pool.workers == 2
    finally:
        pooled.close()
    assert pooled._decode_pool is None
    assert_batches_equal(got, list(pl.BatchLoader(df, cfg, **kw)))
    theirs = JaxLoader(df, jcfg, decode_processes=2, **kw)
    assert_batches_equal(got, list(theirs))
    theirs._decode_pool.close()


@pytest.mark.parametrize("mode", ["classification", "fusion"])
def test_grain_role_matches_jax_unshuffled(prepared, mode):
    from tpuhar.data.grain_loader import GrainBatchLoader as JaxGrain

    jcfg, cfg, dfs = prepared
    got = list(GrainBatchLoader(dfs["val"], cfg, mode=mode, batch_size=4, workers=0))
    assert_batches_equal(got, list(JaxGrain(dfs["val"], jcfg, mode=mode, batch_size=4, workers=0)))
    assert_batches_equal(got, list(pl.BatchLoader(dfs["val"], cfg, mode=mode, batch_size=4, prefetch=0)))
    assert int(got[-1]["n_valid"]) == (len(dfs["val"]) % 4 or 4)


def test_grain_role_workers_match_in_process(prepared):
    _, cfg, dfs = prepared
    a = list(GrainBatchLoader(dfs["val"], cfg, mode="fusion", batch_size=4, workers=0))
    b = list(GrainBatchLoader(dfs["val"], cfg, mode="fusion", batch_size=4, workers=2))
    assert_batches_equal(a, b)


def test_grain_role_shuffles_as_batch_loader(prepared):
    _, cfg, dfs = prepared
    mine = GrainBatchLoader(dfs["train"], cfg, batch_size=4, shuffle=True, drop_last=True, seed=3)
    ref = pl.BatchLoader(dfs["train"], cfg, batch_size=4, shuffle=True, drop_last=True, seed=3, prefetch=0)
    orders = []
    for epoch in (0, 1, 0):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = list(mine)
        assert_batches_equal(got, list(ref))
        orders.append(np.concatenate([b["idx"] for b in got]).tolist())
    assert orders[0] == orders[2] != orders[1]
    assert len(set(orders[0])) == len(orders[0]) == len(dfs["train"]) // 4 * 4


def test_create_dataloaders_grain_backend(prepared):
    from tpuhar.data.loader import create_dataloaders

    jcfg, cfg, dfs = prepared
    cfg.data.loader_backend = jcfg.data.loader_backend = "grain"
    try:
        mine = pl.create_dataloaders(cfg, dfs["train"], dfs["val"], dfs["val"], mode="fusion", device="cpu")
        theirs = create_dataloaders(jcfg, dfs["train"], dfs["val"], dfs["val"], mode="fusion")
    finally:
        cfg.data.loader_backend = jcfg.data.loader_backend = "default"
    for split in ("train", "val", "test"):
        m, t = mine[split], theirs[split]
        assert isinstance(m, GrainBatchLoader)
        assert (len(m), m.batch_size, m.shuffle, m.drop_last, m.seed, m.workers) == (
            len(t), t.batch_size, t.shuffle, t.drop_last, t.seed, t.workers)
    batch = next(iter(mine["val"]))
    assert isinstance(batch["video"], torch.Tensor) and batch["label"].dtype == torch.int64
    assert isinstance(batch["n_valid"], int)


def _encode(imgs_rgb):
    """OpenCV JPEGs of RGB images as the frame bank writer stores them (BGR input)."""
    import cv2

    blob, offs, lens = b"", [], []
    for img in imgs_rgb:
        ok, buf = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert ok
        offs.append(len(blob))
        lens.append(len(buf))
        blob += buf.tobytes()
    return blob, np.asarray(offs, np.int64), np.asarray(lens, np.int64)


def test_native_decoder_matches_jax():
    from tpuhar import native as jax_native

    assert native.decode_available() and jax_native.decode_available()
    path = native.library_path()
    assert path.parent.name == "_build" and path.exists() and path.name.startswith("libtpuhar_decode_")
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (5, 48, 64, 3), dtype=np.uint8)
    blob, offs, lens = _encode(imgs)
    got = native.decode_jpeg_bank(blob, offs, lens, 48, 64)
    np.testing.assert_array_equal(got, jax_native.decode_jpeg_bank(blob, offs, lens, 48, 64))
    # a gap in the middle decodes black; threads change nothing
    offs, lens = np.insert(offs, 2, 0), np.insert(lens, 2, 0)
    one, three = (native.decode_jpeg_bank(blob, offs, lens, 48, 64, threads=t) for t in (1, 3))
    np.testing.assert_array_equal(one, three)
    np.testing.assert_array_equal(one, jax_native.decode_jpeg_bank(blob, offs, lens, 48, 64, threads=3))
    assert not one[2].any()
    out = np.ones((6, 48, 64, 3), np.uint8)
    assert native.decode_jpeg_bank(blob, offs, lens, 48, 64, out=out) is out and not out[2].any()
    with pytest.raises(ValueError, match="out must be"):
        native.decode_jpeg_bank(blob, offs, lens, 48, 64, out=np.zeros((6, 48, 64, 4), np.uint8))
    assert native.decode_jpeg_bank(blob, offs, lens, 32, 32) is None  # another size


def test_read_clip_native_matches_jax(prepared, monkeypatch):
    from tpuhar.data.frames import FrameBankReader as JaxReader

    _, cfg, _ = prepared
    base = cfg.paths.preprocessed_dir
    mine = FrameBankReader(base / "val_frames.bin", base / "val_frame_index.npy")
    theirs = JaxReader(base / "val_frames.bin", base / "val_frame_index.npy")
    H, W = cfg.data.video_resize
    for row in (0, len(mine) // 2, len(mine) - 1):
        got = mine.read_clip(row, (H, W), backend="native", threads=2)
        np.testing.assert_array_equal(got, theirs.read_clip(row, (H, W), backend="native"))
        np.testing.assert_array_equal(mine.read_clip(row, (H, W)), got)  # "auto" takes the native path
        np.testing.assert_array_equal(mine.read_clip(row, (32, 48)), theirs.read_clip(row, (32, 48)))
    with pytest.raises(RuntimeError, match="native decode"):
        mine.read_clip(0, (32, 48), backend="native")  # stored frames are another size
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)  # as where no compiler or libjpeg is found
    assert not native.decode_available()
    with pytest.raises(RuntimeError, match="native decode unavailable"):
        mine.read_clip(0, (H, W), backend="native")
    np.testing.assert_array_equal(mine.read_clip(0, (H, W)), mine.read_clip(0, (H, W), backend="cv2"))
    mine.close()
    theirs.close()
