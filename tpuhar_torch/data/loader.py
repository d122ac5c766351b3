"""Host-side batch loaders (``tpuhar/data/loader.py``): IMU windows and decoded clips →
batches, copied so that the port imports nothing of the JAX package.

- Batches: ``"imu"`` ``(B, C, T)`` f32 featurized windows, ``"video"`` ``(B, T, H, W,
  3)`` uint8 (normalized inside the steps), ``"label"``, ``"idx"`` (the rows' positions
  in the manifest) and ``"n_valid"``.
- Windows come from the packed per-split ``{split}_windows.npy`` banks where the
  manifest has ``bank_idx`` (one memory-mapped gather), else one ``.npy`` per window;
  clips from the per-split JPEG frame banks (``frames.FrameBankReader``), else one seek
  and a sequential read of the clip's span. A missing or broken window gives zeros, a
  missing or broken clip black frames.
- Train loaders shuffle per epoch (``seed + epoch``) and drop the last partial batch;
  eval loaders pad the last batch with zeros and say how many rows are real in
  ``n_valid``.

The loaders yield numpy batches, as the JAX package's do; with ``device`` set they
yield the batch the port's steps take (``to_device``: tensors on that device, labels
int64). Clips decode on threads, or in a pool of processes (``decode_processes``,
``parallel_decode``); ``data.loader_backend="grain"`` gives ``grain_loader.GrainBatchLoader``
instead. pandas and OpenCV are imported by the functions that need them.
"""
from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def to_device(batch: Dict, device) -> Dict:
    """A loader's numpy batch as the port's steps take it: each array a tensor on
    ``device`` (``"label"`` as int64), ``"n_valid"`` a Python int; ``"idx"`` and the
    ``return_info`` lists stay on the host."""
    out = {}
    for key, value in batch.items():
        if key == "n_valid":
            out[key] = int(value)
        elif key == "idx" or not isinstance(value, np.ndarray):
            out[key] = value
        else:
            t = torch.from_numpy(value)
            out[key] = (t.long() if key == "label" else t).to(device)
    return out


# ---------------------------------------------------------------------------------
# IMU windows
# ---------------------------------------------------------------------------------
def resolve_imu_path(imu_path: str, preprocessed_dir) -> Path:
    p = Path(str(imu_path))
    if p.is_absolute():
        return p
    cand = Path(preprocessed_dir) / p
    if cand.exists():
        return cand
    cand2 = Path.cwd() / p
    if cand2.exists():
        return cand2
    return cand


def load_imu_window(imu_path: str, preprocessed_dir, channels: int, window: int) -> np.ndarray:
    """One preprocessed window as ``(C, T)`` f32: a ``(C, T)`` file is taken as it is,
    any other 2-D shape padded or cropped to ``(T, C)`` first; zeros on any failure."""
    try:
        f = resolve_imu_path(imu_path, preprocessed_dir)
        if not f.exists():
            return np.zeros((channels, window), dtype=np.float32)
        data = np.asarray(np.load(str(f)), dtype=np.float32)
        if data.ndim != 2:
            return np.zeros((channels, window), dtype=np.float32)
        if data.shape == (channels, window):
            data = data.T
        if data.shape != (window, channels):
            out = np.zeros((window, channels), dtype=np.float32)
            t, c = min(window, data.shape[0]), min(channels, data.shape[1])
            out[:t, :c] = data[:t, :c]
            data = out
        return np.ascontiguousarray(data.T)
    except Exception:
        return np.zeros((channels, window), dtype=np.float32)


# ---------------------------------------------------------------------------------
# Clips
# ---------------------------------------------------------------------------------
def clip_frame_indices(total_frames: int, fps: float, start_frame: int, *, num_frames: int,
                       window_seconds: float) -> np.ndarray:
    """The clip's frames: ``linspace(start, end, num_frames)`` over the window's span,
    clipped to the video (the same selection for the online decoder and the frame
    banks)."""
    window_frames = max(int(round(window_seconds * fps)), 1)
    start = int(np.clip(start_frame, 0, max(total_frames - 1, 0)))
    end = min(start + window_frames - 1, total_frames - 1)
    if end >= start:
        idx = np.linspace(start, end, num_frames).astype(int)
    else:
        idx = np.full((num_frames,), start, dtype=int)
    return np.clip(idx, 0, total_frames - 1)


def decode_clip(video_path, start_frame: int, *, num_frames: int, window_seconds: float,
                fallback_fps: float, resize_hw) -> np.ndarray:
    """One clip → ``(num_frames, H, W, 3)`` uint8 RGB, resized: one seek to the first
    frame, then a sequential read to the last. Any failure gives black frames."""
    import cv2

    H, W = resize_hw
    black = np.zeros((num_frames, H, W, 3), dtype=np.uint8)
    video_path = Path(video_path)
    if not video_path.exists():
        return black
    try:
        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            cap.release()
            return black
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 0
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 0.0
        if total <= 0:
            cap.release()
            return black
        if fps <= 1e-6:
            fps = fallback_fps
        idx = clip_frame_indices(total, fps, start_frame, num_frames=num_frames, window_seconds=window_seconds)
        out = black.copy()
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx[0]))
        pos, want = int(idx[0]), 0
        while want < num_frames and pos <= int(idx[-1]):
            ret, frame = cap.read()
            if not ret or frame is None:
                break
            while want < num_frames and idx[want] == pos:
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if rgb.shape[:2] != (H, W):
                    rgb = cv2.resize(rgb, (W, H), interpolation=cv2.INTER_LINEAR)
                out[want] = rgb
                want += 1
            pos += 1
        cap.release()
        return out
    except Exception:
        return black


# ---------------------------------------------------------------------------------
# Batch loaders
# ---------------------------------------------------------------------------------
def epoch_order(n: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    """The rows of an epoch: in order, or shuffled by ``seed + epoch``."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    return order


class BatchLoader:
    """A deterministic, optionally shuffled batch iterator over a window manifest.

    ``mode``: "classification" → ``{imu, label, idx, n_valid}``; "cross_modal" →
    ``{imu, video, idx, n_valid}``; "fusion" → ``{imu, video, label, idx, n_valid}``.
    ``decode_workers`` threads decode a batch's clips, or with ``decode_processes`` > 0
    (default ``data.decode_processes``) a ``parallel_decode.ProcessDecodePool`` of that
    many processes, made at the first batch of clips (``close`` ends it); a ``prefetch``
    thread builds the next batches ahead. ``frame_backend`` is ``FrameBankReader.
    read_clip``'s ``backend`` ("auto", "native" or "cv2"). ``return_info`` passes
    ``class_name``/``user_id`` through as lists. ``device``: yield ``to_device`` batches
    on it (``None``: numpy, as the JAX package's loader).
    """

    def __init__(
        self,
        df,
        config,
        *,
        mode: str = "classification",
        batch_size: Optional[int] = None,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        decode_workers: int = 8,
        decode_processes: Optional[int] = None,
        prefetch: int = 2,
        return_info: bool = False,
        device=None,
        frame_backend: str = "auto",
    ):
        self.df = df.reset_index(drop=True)
        self.config = config
        self.mode = mode
        d, t = config.data, config.training
        self.batch_size = batch_size or (t.pretrain_batch_size if mode == "cross_modal" else t.train_batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.decode_workers = decode_workers
        self.decode_processes = int(
            decode_processes if decode_processes is not None else getattr(d, "decode_processes", 0) or 0
        )
        self._decode_pool = None
        self.frame_backend = frame_backend
        self.prefetch = prefetch
        self.return_info = return_info
        self.device = device
        self.channels = d.imu_channels
        self.window = d.imu_window_size
        self.window_seconds = d.imu_window_size / float(d.imu_sampling_rate)
        self._banks = self._open_banks()
        self._frame_banks = self._open_frame_banks() if mode in ("cross_modal", "fusion") else None

    def _splits_with_banks(self):
        """``(split, its largest bank_idx)`` for each split, or None when the manifest
        has no bank columns."""
        if "bank_idx" not in self.df.columns or "split" not in self.df.columns:
            return None
        return [(s, int(self.df[self.df["split"] == s]["bank_idx"].max())) for s in self.df["split"].unique()]

    def _open_frame_banks(self):
        """The per-split JPEG frame banks the preprocessor wrote, where every split has
        one covering its rows; rows without cached frames fall back to the decoder."""
        splits = self._splits_with_banks()
        if splits is None:
            return None
        from .frames import FrameBankReader

        banks = {}
        self._frame_bank_paths = {}
        for split, top in splits:
            base = Path(self.config.paths.preprocessed_dir)
            bin_path, idx_path = base / f"{split}_frames.bin", base / f"{split}_frame_index.npy"
            if not (bin_path.exists() and idx_path.exists()):
                return None
            reader = FrameBankReader(bin_path, idx_path)
            if reader.table.shape[1] != self.config.data.video_frames_per_window or top >= len(reader):
                return None
            banks[split] = reader
            self._frame_bank_paths[split] = (str(bin_path), str(idx_path))
        return banks

    def _open_banks(self):
        """The packed per-split window banks, memory-mapped, where every split has one
        covering its rows; else None (one file per window)."""
        splits = self._splits_with_banks()
        if splits is None:
            return None
        banks = {}
        for split, top in splits:
            path = Path(self.config.paths.preprocessed_dir) / f"{split}_windows.npy"
            if not path.exists():
                return None
            bank = np.load(path, mmap_mode="r")
            if bank.ndim != 3 or bank.shape[1:] != (self.window, self.channels) or top >= len(bank):
                return None
            banks[split] = bank
        return banks

    def __len__(self) -> int:
        n = len(self.df)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        return epoch_order(len(self.df), self.shuffle, self.seed, self.epoch)

    def _make_batch(self, rows_idx: np.ndarray) -> Dict:
        B = self.batch_size
        n_valid = len(rows_idx)
        d = self.config.data
        rows = self.df.iloc[rows_idx]
        imu = np.zeros((B, self.channels, self.window), dtype=np.float32)
        for i, (_, row) in enumerate(rows.iterrows()):
            if self._banks is not None:
                imu[i] = np.ascontiguousarray(self._banks[row["split"]][int(row["bank_idx"])].T)
            else:
                imu[i] = load_imu_window(row["imu_window_path"], self.config.paths.preprocessed_dir,
                                         self.channels, self.window)
        batch = {
            "imu": imu,
            "idx": np.pad(rows_idx.astype(np.int32), (0, B - n_valid)),
            "n_valid": np.int32(n_valid),
        }
        if self.mode in ("classification", "fusion"):
            batch["label"] = np.pad(rows["label"].to_numpy(dtype=np.int32), (0, B - n_valid))
            if self.return_info:
                for col in ("class_name", "user_id"):
                    if col in rows.columns:
                        batch[col] = rows[col].tolist() + [None] * (B - n_valid)
        if self.mode in ("cross_modal", "fusion"):
            H, W = d.video_resize
            T = d.video_frames_per_window
            video = np.zeros((B, T, H, W, 3), dtype=np.uint8)
            base = Path(self.config.paths.base_input)
            threads = int(getattr(d, "decode_threads", 1) or 1)
            if self.decode_processes > 0:
                self._decode_with_processes(rows, video, base, (H, W), T, threads)
                batch["video"] = video
                return batch

            def _decode(i_row):
                i, row = i_row
                if self._frame_banks is not None:
                    reader = self._frame_banks[row["split"]]
                    r = int(row["bank_idx"])
                    if reader.has_frames(r):
                        video[i] = reader.read_clip(r, (H, W), backend=self.frame_backend, threads=threads)
                        return
                    if not bool(row.get("video_exists", True)):
                        return  # a black clip
                video[i] = decode_clip(
                    base / str(row["video_path"]), int(row.get("start_frame", 0)), num_frames=T,
                    window_seconds=self.window_seconds, fallback_fps=float(d.video_fps), resize_hw=(H, W),
                )

            items = list(enumerate(r for _, r in rows.iterrows()))
            if self.decode_workers > 1 and n_valid > 1:
                with cf.ThreadPoolExecutor(self.decode_workers) as ex:
                    list(ex.map(_decode, items))
            else:
                for item in items:
                    _decode(item)
            batch["video"] = video
        return batch

    def _decode_with_processes(self, rows, video, base: Path, resize_hw, T: int, threads: int) -> None:
        """A batch's clips decoded in the process pool, each row as the thread path
        decodes it: cached frames, black (no video), or one decode of the mp4."""
        from .parallel_decode import ProcessDecodePool

        if self._decode_pool is None:
            self._decode_pool = ProcessDecodePool(self.decode_processes)
        d = self.config.data
        specs = []
        for i, (_, row) in enumerate(rows.iterrows()):
            if self._frame_banks is not None:
                r, split = int(row["bank_idx"]), row["split"]
                if self._frame_banks[split].has_frames(r):
                    bin_path, idx_path = self._frame_bank_paths[split]
                    specs.append({"kind": "bank", "i": i, "bin_path": bin_path, "idx_path": idx_path, "row": r,
                                  "resize_hw": resize_hw, "backend": self.frame_backend, "threads": threads})
                    continue
                if not bool(row.get("video_exists", True)):
                    specs.append({"kind": "black", "i": i})
                    continue
            specs.append({
                "kind": "video", "i": i, "path": str(base / str(row["video_path"])),
                "start_frame": int(row.get("start_frame", 0)), "num_frames": T,
                "window_seconds": self.window_seconds, "fallback_fps": float(d.video_fps), "resize_hw": resize_hw,
            })
        self._decode_pool.decode_batch(specs, video)

    def close(self) -> None:
        """End the decode pool's processes, if any were started."""
        if self._decode_pool is not None:
            self._decode_pool.close()
            self._decode_pool = None

    def _batch_indices(self):
        order = self._order()
        for b in range(len(self)):
            yield order[b * self.batch_size: min((b + 1) * self.batch_size, len(order))]

    def _numpy_batches(self) -> Iterator[Dict]:
        if self.prefetch <= 0:
            for rows_idx in self._batch_indices():
                yield self._make_batch(rows_idx)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for rows_idx in self._batch_indices():
                    if stop.is_set():
                        return
                    q.put(self._make_batch(rows_idx))
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            while t.is_alive():  # drain, so that the producer can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def __iter__(self) -> Iterator[Dict]:
        for batch in self._numpy_batches():
            yield batch if self.device is None else to_device(batch, self.device)


def create_dataloaders(config, train_df, val_df, test_df, mode: str = "cross_modal", shuffle_train: bool = True,
                       *, device=None) -> Dict[str, BatchLoader]:
    """The train (shuffled, last partial batch dropped, ``training.seed``), val and test
    loaders of a stage; ``device`` as ``BatchLoader``'s. ``data.loader_backend="grain"``
    gives ``grain_loader.GrainBatchLoader``s (``data.grain_workers`` processes) with the
    same batches."""
    if mode not in ("cross_modal", "classification", "fusion"):
        raise ValueError(f"Unknown mode: {mode}")
    cls = BatchLoader
    if getattr(config.data, "loader_backend", "default") == "grain":
        from .grain_loader import GrainBatchLoader

        cls = GrainBatchLoader
    seed = config.training.seed
    return {
        "train": cls(train_df, config, mode=mode, shuffle=shuffle_train, drop_last=True, seed=seed, device=device),
        "val": cls(val_df, config, mode=mode, device=device),
        "test": cls(test_df, config, mode=mode, device=device),
    }
