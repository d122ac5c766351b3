"""The multi-process loader of ``data.loader_backend="grain"`` (``tpuhar/data/
grain_loader.py``), on ``torch.utils.data.DataLoader``.

The JAX package builds this loader on Google Grain, whose import loads JAX; the port
imports no JAX, so it fills the same role with PyTorch's ``DataLoader`` (the reference's
own loader): ``workers`` spawned processes (``data.grain_workers``; 0 maps in process)
each build samples from a picklable mapper that opens its window banks and frame banks
once per process.

The contract is ``BatchLoader``'s and the JAX module's: batch dicts ``{imu, idx,
label?, video?, n_valid}`` of numpy arrays (or ``to_device`` tensors with ``device``),
the final partial batch zero-padded with its real rows in ``n_valid`` (or dropped with
``drop_last``), and ``set_epoch``. Unshuffled, the batches equal ``BatchLoader``'s and
the JAX module's; shuffled, each epoch takes ``BatchLoader``'s order for the same seed
and epoch (Grain's index shuffle cannot be reproduced without Grain). pandas is imported
by the constructor only.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch.utils.data

from .loader import epoch_order, to_device


class _SampleMapper(torch.utils.data.Dataset):
    """Manifest row index → sample dict, from the manifest's columns as plain arrays
    (cheap to pickle into each worker); the banks open lazily in each process."""

    def __init__(self, df, config, mode: str):
        d = config.data
        self.mode = mode
        self.channels = int(d.imu_channels)
        self.window = int(d.imu_window_size)
        self.window_seconds = self.window / float(d.imu_sampling_rate)
        self.resize_hw = tuple(d.video_resize)
        self.num_frames = int(d.video_frames_per_window)
        self.fallback_fps = float(d.video_fps)
        self.preprocessed_dir = str(config.paths.preprocessed_dir)
        self.base_input = str(config.paths.base_input)
        n = len(df)
        self.n = n

        def column(name, dtype, default=None):
            if name in df:
                return df[name].astype(str).to_numpy() if dtype is str else df[name].to_numpy(dtype=dtype)
            return default

        self.labels = column("label", np.int32, np.zeros(n, np.int32))
        self.splits = column("split", str)
        self.bank_idx = column("bank_idx", np.int64)
        self.imu_paths = column("imu_window_path", str)
        self.video_paths = column("video_path", str)
        self.start_frames = column("start_frame", np.int64, np.zeros(n, np.int64))
        self.video_exists = column("video_exists", bool, np.ones(n, bool))
        self._imu_banks: Optional[Dict] = None
        self._frame_banks: Optional[Dict] = None

    def __len__(self) -> int:
        return self.n

    def _ensure_open(self) -> None:
        """Open the banks once per process; both dicts are built whole before they are
        published, so a concurrent reader never sees half of them."""
        if self._imu_banks is not None:
            return
        imu_banks, frame_banks = {}, {}
        if self.splits is not None and self.bank_idx is not None:
            from .frames import FrameBankReader

            pre = Path(self.preprocessed_dir)
            for split in np.unique(self.splits):
                wpath = pre / f"{split}_windows.npy"
                if wpath.exists():
                    bank = np.load(wpath, mmap_mode="r")
                    if bank.ndim == 3 and bank.shape[1:] == (self.window, self.channels):
                        imu_banks[split] = bank
                bpath, ipath = pre / f"{split}_frames.bin", pre / f"{split}_frame_index.npy"
                if bpath.exists() and ipath.exists():
                    reader = FrameBankReader(bpath, ipath)
                    if reader.table.shape[1] == self.num_frames:
                        frame_banks[split] = reader
        self._frame_banks = frame_banks
        self._imu_banks = imu_banks

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_imu_banks"] = state["_frame_banks"] = None  # opened again in the worker
        return state

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        from .loader import decode_clip, load_imu_window

        self._ensure_open()
        i = int(idx)
        split = self.splits[i] if self.splits is not None else None
        sample: Dict[str, np.ndarray] = {"idx": np.int32(i)}
        bank = self._imu_banks.get(split) if split is not None else None
        if bank is not None and self.bank_idx is not None:
            sample["imu"] = np.ascontiguousarray(bank[int(self.bank_idx[i])].T)
        else:
            sample["imu"] = load_imu_window(self.imu_paths[i], self.preprocessed_dir, self.channels, self.window)
        if self.mode in ("classification", "fusion"):
            sample["label"] = np.int32(self.labels[i])
        if self.mode in ("cross_modal", "fusion"):
            H, W = self.resize_hw
            clip = None
            reader = self._frame_banks.get(split) if split is not None else None
            if reader is not None and self.bank_idx is not None:
                r = int(self.bank_idx[i])
                if reader.has_frames(r):
                    clip = reader.read_clip(r, (H, W))
                elif not bool(self.video_exists[i]):
                    clip = np.zeros((self.num_frames, H, W, 3), np.uint8)  # a black clip
            if clip is None:
                clip = decode_clip(
                    Path(self.base_input) / self.video_paths[i], int(self.start_frames[i]),
                    num_frames=self.num_frames, window_seconds=self.window_seconds,
                    fallback_fps=self.fallback_fps, resize_hw=(H, W),
                )
            sample["video"] = clip
        return sample


def _stack(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """A batch of samples stacked key by key (the ``DataLoader``'s collate)."""
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in samples[0]}


class _EpochBatches(torch.utils.data.Sampler):
    """The row indices of each batch of the loader's current epoch."""

    def __init__(self, loader: "GrainBatchLoader"):
        self.loader = loader

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[List[int]]:
        loader = self.loader
        order, B = epoch_order(len(loader.df), loader.shuffle, loader.seed, loader.epoch), loader.batch_size
        for b in range(len(loader)):
            yield order[b * B: (b + 1) * B].tolist()


class GrainBatchLoader:
    """``BatchLoader``'s batches from a ``torch.utils.data.DataLoader``: ``workers`` > 0
    maps samples in that many spawned processes (started each epoch, ended with it),
    ``prefetch_per_worker`` batches ahead each; 0 maps in process. ``device`` as
    ``BatchLoader``'s."""

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
        workers: Optional[int] = None,
        prefetch_per_worker: int = 2,
        device=None,
    ):
        self.df = df.reset_index(drop=True)
        self.config = config
        self.mode = mode
        t = config.training
        self.batch_size = batch_size or (t.pretrain_batch_size if mode == "cross_modal" else t.train_batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.workers = int(workers if workers is not None else getattr(config.data, "grain_workers", 0) or 0)
        self.prefetch_per_worker = prefetch_per_worker
        self.device = device
        self._mapper = _SampleMapper(self.df, config, mode)

    def __len__(self) -> int:
        n = len(self.df)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _pad_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        B = self.batch_size
        n_valid = len(batch["idx"])
        out = {}
        for k, v in batch.items():
            if n_valid < B:
                v = np.pad(v, [(0, B - n_valid)] + [(0, 0)] * (v.ndim - 1))
            out[k] = v
        out["imu"] = out["imu"].astype(np.float32)
        out["n_valid"] = np.int32(n_valid)
        return out

    def __iter__(self) -> Iterator[Dict]:
        kw = {}
        if self.workers > 0:
            kw = dict(num_workers=self.workers, multiprocessing_context="spawn",
                      prefetch_factor=self.prefetch_per_worker)
        loader = torch.utils.data.DataLoader(self._mapper, batch_sampler=_EpochBatches(self), collate_fn=_stack, **kw)
        for batch in loader:
            batch = self._pad_batch(batch)
            yield batch if self.device is None else to_device(batch, self.device)
