"""Offline preprocessing (``tpuhar/data/preprocess.py``): the raw UESTC-MMEA-CL layout →
per-window ``.npy`` files, the metadata CSV, the packed window bank and the frame bank.

``Preprocessor.preprocess_split`` parses and validates a split's lines, windows every
sequence at once, then writes in sample order:

- ``preprocessed/{split}/{class_dir}_{prefix}_w{idx}.npy``, f32 ``(window, 6)``;
- ``{split}_metadata.csv`` (``manifest.METADATA_COLUMNS``, ``bank_idx`` its row in the
  bank), ``{split}_windows.npy`` (the ``(N, window, 6)`` bank), and with
  ``data.extract_frames`` the JPEG frame bank (``frames.FrameBankWriter``);
- ``run_full_preprocessing``: every split, then ``preprocessing_stats.json`` (the
  reference's 11 counters and ``truncated_sequences``) and ``data_fingerprint.json``.

Three featurize routes, as the JAX package has them:

- ``featurize_backend="device"`` (the default): sequences padded to power-of-two buckets
  capped at ``data.max_sequence_length`` and featurized a bucket at a time by
  ``ops.featurize.preprocess_sequence`` on the preprocessor's ``device`` (one call per
  chunk of 128, where the JAX package maps a jitted function over the chunk). A longer
  sequence is cut to the cap, counted and warned about: the cap changes which windows
  come out.
- ``featurize_backend="host"``: numpy and scipy, the reference's chain.
- ``zscore_scope="window"``: raw counts sliced into windows first, then each window
  through the serving featurizer, ``ops.fused_window.featurize_windows_auto`` (the hand
  kernel on a CUDA device, its plain version on the CPU).

pandas and scipy are imported by the functions that use them.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import featurize as F
from ..ops.fused_window import featurize_windows_auto
from ..utils import resolve_device
from . import manifest as M

FINGERPRINT_FILENAME = "data_fingerprint.json"
DEVICE_CHUNK = 128  # sequences of one bucket featurized in one call
WINDOW_CHUNK = 1024  # windows featurized in one call (zscore_scope="window")


def data_fingerprint(preprocessed_dir, splits=("train", "val", "test")) -> Dict[str, str]:
    """sha256 of what a trained checkpoint is bound to, per split: the packed window bank,
    the JPEG frame bank and its index, and the metadata's label sequence. It leaves out
    the CSV's paths, so two equal regenerations into different directories give equal
    fingerprints; checkpoint writers record it, cross-run readers verify it."""
    import hashlib

    import pandas as pd

    d = Path(preprocessed_dir)
    out: Dict[str, str] = {}
    for split in splits:
        h = hashlib.sha256()
        found = False
        for name in (f"{split}_windows.npy", f"{split}_frames.bin", f"{split}_frame_index.npy"):
            p = d / name
            if p.exists():
                found = True
                h.update(name.encode())
                with open(p, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 22), b""):
                        h.update(chunk)
        meta = d / f"{split}_metadata.csv"
        if meta.exists():
            found = True
            labels = pd.read_csv(meta, usecols=["label"])["label"]
            h.update(b"labels")
            h.update(np.asarray(labels, np.int64).tobytes())
        if found:
            out[split] = h.hexdigest()
    return out


def verify_data_fingerprint(recorded_path, preprocessed_dir, *, context: str = "") -> bool:
    """True when a checkpoint's recorded fingerprint matches the data (or none was
    recorded: a warning is printed); ``RuntimeError`` on a mismatch, since scoring would
    compare a model with data it was not trained on."""
    recorded_path = Path(recorded_path)
    where = f" [{context}]" if context else ""
    if not recorded_path.exists():
        print(
            f"WARNING{where}: no recorded data fingerprint at {recorded_path} (checkpoints predate the guard); "
            "results are only valid if the preprocessed data is unchanged since training"
        )
        return True
    recorded = json.loads(recorded_path.read_text())
    current = data_fingerprint(preprocessed_dir, splits=tuple(recorded))
    if recorded != current:
        bad = sorted(k for k in recorded if current.get(k) != recorded[k])
        raise RuntimeError(
            f"data fingerprint mismatch{where}: splits {bad} under {preprocessed_dir} differ from what these "
            f"checkpoints were trained on ({recorded_path}). The shared preprocessed data was regenerated "
            "differently since training — retrain (or re-point --root) instead of scoring a mismatched "
            "model/data pair."
        )
    return True


def _bucket_length(n: int, window: int, max_len: int) -> int:
    """The padded length of a length-``n`` sequence: the next power of two from 256 (or
    ``window``) that holds it, capped at ``max_len``."""
    b = max(window, 256)
    while b < n and b < max_len:
        b *= 2
    return min(max(b, window), max_len)


class Preprocessor:
    """The dataset preprocessor, with the reference's bookkeeping; featurizes on
    ``device`` (``"cuda"`` raises without a card)."""

    def __init__(self, config, *, device="cuda"):
        self.config = config
        self.paths = config.paths
        self.data_cfg = config.data
        self.device = resolve_device(device, "Preprocessor")
        self.preprocessing_stats = {
            "total_samples": 0,
            "skipped_samples": 0,
            "total_windows": 0,
            "samples_with_video": 0,
            "samples_without_video": 0,
            "classes_found": set(),
            "bad_format_lines": 0,
            "missing_sensor_files": 0,
            "missing_video_files": 0,
            "prefix_mismatch": 0,
            "too_short_no_pad": 0,
            # sequences cut to max_sequence_length on the device route
            "truncated_sequences": 0,
        }

    # -- IO ------------------------------------------------------------------------
    def load_raw_imu(self, sensor_relpath: str) -> Optional[np.ndarray]:
        """An N×6 raw-count sensor CSV (wider ones cut, narrower ones zero-filled to 6
        columns), or None on error."""
        import pandas as pd

        full_path = Path(self.paths.base_input) / sensor_relpath
        if not full_path.exists():
            self.preprocessing_stats["missing_sensor_files"] += 1
            return None
        try:
            data = pd.read_csv(full_path, header=None).values.astype(np.float32)
            if data.ndim == 1:
                data = data.reshape(1, -1)
            if data.shape[1] < 6:
                data = np.hstack([data, np.zeros((data.shape[0], 6 - data.shape[1]), dtype=np.float32)])
            elif data.shape[1] > 6:
                data = data[:, :6]
            return data
        except Exception:
            return None

    # -- signal path ---------------------------------------------------------------
    def _resampled(self, raw: np.ndarray) -> np.ndarray:
        """``raw`` resampled from ``imu_original_rate`` to ``imu_sampling_rate`` on the
        device, where the two differ."""
        d = self.data_cfg
        if d.imu_original_rate is None or float(d.imu_original_rate) == float(d.imu_sampling_rate):
            return raw
        n_target = int(round(raw.shape[0] * float(d.imu_sampling_rate) / float(d.imu_original_rate)))
        if n_target <= 1:
            return raw
        return F.fourier_resample(torch.from_numpy(raw).to(self.device), n_target).cpu().numpy()

    def _windows_host(self, raw: np.ndarray) -> List[np.ndarray]:
        """The reference's chain in numpy and scipy (for golden comparisons)."""
        from scipy import signal

        d = self.data_cfg
        acc = raw[:, :3] / float(d.Racc)
        gyro = raw[:, 3:6] / float(d.Rgyro)
        imu = np.concatenate([acc, gyro], axis=1).astype(np.float32)

        if d.imu_original_rate is not None and float(d.imu_original_rate) != float(d.imu_sampling_rate):
            n_target = int(round(imu.shape[0] * float(d.imu_sampling_rate) / float(d.imu_original_rate)))
            if n_target > 1:
                imu = np.stack(
                    [signal.resample(imu[:, c], n_target) for c in range(imu.shape[1])], axis=1
                ).astype(np.float32)

        k = int(d.median_filter_kernel)
        if k > 1:
            if k % 2 == 0:
                k += 1
            imu = np.stack(
                [signal.medfilt(imu[:, c], kernel_size=k) for c in range(imu.shape[1])], axis=1
            ).astype(np.float32)
        if d.normalize_imu:
            mean = imu.mean(axis=0, keepdims=True)
            std = imu.std(axis=0, keepdims=True) + 1e-8
            imu = ((imu - mean) / std).astype(np.float32)

        window, stride = int(d.imu_window_size), int(d.imu_stride)
        n = imu.shape[0]
        if n < window:
            if not d.pad_short_sequences:
                self.preprocessing_stats["too_short_no_pad"] += 1
                return []
            imu = np.vstack([imu, np.zeros((window - n, imu.shape[1]), dtype=np.float32)])
            n = window
        return [imu[s: s + window] for s in range(0, n - window + 1, stride)]

    def _warn_truncation(self, n: int, bucket: int) -> None:
        self.preprocessing_stats["truncated_sequences"] += 1
        print(
            f"[Preprocess] WARNING: sequence of length {n} truncated to {bucket} on the device path "
            f"(data.max_sequence_length); windows past the cap are dropped and z-score stats cover the prefix "
            f"only — use featurize_backend='host' or raise the cap for full-sequence parity"
        )

    def make_windows(self, raw: np.ndarray) -> List[np.ndarray]:
        return self.make_windows_batch([raw])[0]

    def make_windows_batch(self, raws: List[np.ndarray]) -> List[List[np.ndarray]]:
        """The windows of many sequences: by window scope, on the host, or a bucket at a
        time on the device."""
        if self.data_cfg.zscore_scope == "window":
            return self._windows_per_window_batch(raws)
        if self.data_cfg.featurize_backend == "host":
            return [self._windows_host(r) for r in raws]
        return self._windows_device_batch(raws)

    def _windows_per_window_batch(self, raws: List[np.ndarray]) -> List[List[np.ndarray]]:
        """``zscore_scope="window"``: raw counts sliced into windows first (short
        sequences zero-padded to one window), then each window through the serving
        featurizer (unit scale, the median filter with zero-padded window edges, the
        per-window z-score), so that training sees what the engine serves."""
        d = self.data_cfg
        window, stride = int(d.imu_window_size), int(d.imu_stride)
        slices: List[np.ndarray] = []
        owners: List[int] = []
        for i, raw in enumerate(raws):
            raw = self._resampled(raw)
            n = raw.shape[0]
            if n < window:
                if not d.pad_short_sequences:
                    self.preprocessing_stats["too_short_no_pad"] += 1
                    continue
                raw = np.vstack([raw, np.zeros((window - n, raw.shape[1]), np.float32)])
                n = window
            for s in range(0, n - window + 1, stride):
                slices.append(raw[s: s + window])
                owners.append(i)

        results: List[List[np.ndarray]] = [[] for _ in raws]
        for start in range(0, len(slices), WINDOW_CHUNK):
            # C order: a sensor CSV's values come column-major out of pandas, and the
            # kernel takes a contiguous (B, T, 6) tensor
            chunk = torch.from_numpy(np.ascontiguousarray(np.stack(slices[start: start + WINDOW_CHUNK]),
                                                          dtype=np.float32))
            feats = featurize_windows_auto(
                chunk.to(self.device), kernel_size=int(d.median_filter_kernel), normalize=bool(d.normalize_imu),
                racc=float(d.Racc), rgyro=float(d.Rgyro),
            ).cpu().numpy()
            feats = np.swapaxes(feats, 1, 2)  # (B, C, T) → time-major (B, T, C), as the sequence path stores
            for j, owner in enumerate(owners[start: start + WINDOW_CHUNK]):
                results[owner].append(feats[j].astype(np.float32))
        return results

    def _windows_device_batch(self, raws: List[np.ndarray]) -> List[List[np.ndarray]]:
        d = self.data_cfg
        window, stride = int(d.imu_window_size), int(d.imu_stride)
        cap = int(d.max_sequence_length)
        prepped: List[Optional[np.ndarray]] = []
        for raw in raws:
            raw = self._resampled(raw)
            if raw.shape[0] < window and not d.pad_short_sequences:
                self.preprocessing_stats["too_short_no_pad"] += 1
                prepped.append(None)
            else:
                prepped.append(raw)

        results: List[List[np.ndarray]] = [[] for _ in raws]
        by_bucket: Dict[int, List[int]] = {}
        for i, raw in enumerate(prepped):
            if raw is not None:
                by_bucket.setdefault(_bucket_length(raw.shape[0], window, cap), []).append(i)
        for bucket, idxs in by_bucket.items():
            for start in range(0, len(idxs), DEVICE_CHUNK):
                chunk = idxs[start: start + DEVICE_CHUNK]
                stacked = np.zeros((len(chunk), bucket, 6), np.float32)
                lengths = np.zeros((len(chunk),), np.int64)
                for j, i in enumerate(chunk):
                    raw = prepped[i]
                    n_eff = min(raw.shape[0], bucket)
                    if n_eff < raw.shape[0]:
                        self._warn_truncation(raw.shape[0], bucket)
                    stacked[j, :n_eff] = raw[:n_eff]
                    lengths[j] = n_eff
                windows, n_valid = F.preprocess_sequence(
                    torch.from_numpy(stacked).to(self.device), torch.from_numpy(lengths).to(self.device),
                    window=window, stride=stride, kernel_size=int(d.median_filter_kernel),
                    normalize=bool(d.normalize_imu), racc=float(d.Racc), rgyro=float(d.Rgyro),
                )
                windows, n_valid = windows.cpu().numpy(), n_valid.cpu().numpy()
                for j, i in enumerate(chunk):
                    results[i] = list(windows[j, : int(n_valid[j])])
        return results

    # -- splits --------------------------------------------------------------------
    def preprocess_split(self, split: str, save: bool = True):
        """One split: (1) parse and validate its lines and load the raw sequences, (2)
        window them all at once, (3) write the artifacts in sample order. Returns the
        metadata DataFrame."""
        import pandas as pd

        lines = M.load_split_lines(self.config, split)
        stats = self.preprocessing_stats
        stats["total_samples"] += len(lines)
        d = self.data_cfg
        base = Path(self.paths.base_input)
        pre = Path(self.paths.preprocessed_dir)
        records = []
        all_windows = []

        frame_writer = None
        if save and getattr(d, "extract_frames", False):
            from .frames import FrameBankWriter

            frame_writer = FrameBankWriter(
                pre / f"{split}_frames.bin", num_frames=int(d.video_frames_per_window),
                resize_hw=tuple(d.video_resize), jpeg_quality=int(d.frame_jpeg_quality),
            )

        samples = []  # (info, line, video_ok, raw)
        for line in lines:
            try:
                info = M.parse_split_line(line)
            except M.SplitLineError:
                stats["bad_format_lines"] += 1
                stats["skipped_samples"] += 1
                continue
            stats["classes_found"].add(info.class_dir)
            sensor_ok = (base / info.sensor_path).exists()
            video_ok = (base / info.video_path).exists()
            if not sensor_ok:
                stats["missing_sensor_files"] += 1
                stats["skipped_samples"] += 1
                continue
            if video_ok:
                stats["samples_with_video"] += 1
            else:
                stats["samples_without_video"] += 1
                stats["missing_video_files"] += 1
                if d.require_video:
                    stats["skipped_samples"] += 1
                    continue
            if Path(info.sensor_path).stem != Path(info.video_path).stem:
                stats["prefix_mismatch"] += 1
                stats["skipped_samples"] += 1
                continue
            raw = self.load_raw_imu(info.sensor_path)
            if raw is None or raw.size == 0:
                stats["skipped_samples"] += 1
                continue
            samples.append((info, line, video_ok, raw))

        all_sample_windows = self.make_windows_batch([s[3] for s in samples])

        out_dir = pre / split
        for (info, line, video_ok, _), windows in zip(samples, all_sample_windows):
            if not windows:
                stats["skipped_samples"] += 1
                continue
            if save:
                out_dir.mkdir(parents=True, exist_ok=True)
            window_start_frames = []
            for w_idx, window in enumerate(windows):
                stats["total_windows"] += 1
                start_frame = M.estimate_start_frame(
                    w_idx, float(d.imu_stride), float(d.imu_sampling_rate), float(d.video_fps)
                )
                imu_path = None
                if save:
                    fpath = out_dir / f"{info.class_dir}_{info.sample_prefix}_w{w_idx}.npy"
                    np.save(fpath, window.astype(np.float32))
                    imu_path = str(fpath)
                rec = M.window_record(split, info, line, w_idx, video_ok, window.shape, start_frame, imu_path)
                rec["bank_idx"] = len(records)
                records.append(rec)
                all_windows.append(window.astype(np.float32))
                window_start_frames.append(start_frame)
            if frame_writer is not None:
                if video_ok:
                    frame_writer.add_video(
                        base / info.video_path, window_start_frames,
                        window_seconds=float(d.imu_window_size) / float(d.imu_sampling_rate),
                        fallback_fps=float(d.video_fps),
                    )
                else:
                    frame_writer.add_missing(len(window_start_frames))

        df = pd.DataFrame(records)
        if save:
            pre.mkdir(parents=True, exist_ok=True)
            df.to_csv(pre / f"{split}_metadata.csv", index=False)
            if all_windows:  # the packed bank the loaders memory-map
                np.save(pre / f"{split}_windows.npy", np.stack(all_windows))
            if frame_writer is not None:
                frame_writer.finalize(pre / f"{split}_frame_index.npy")
        return df

    def run_full_preprocessing(self) -> Dict:
        """Every split (one without a split file is skipped with a warning), then the
        stats and the fingerprint. Returns ``{split: metadata DataFrame}``."""
        results = {}
        for split in ["train", "val", "test"]:
            try:
                results[split] = self.preprocess_split(split, save=True)
            except FileNotFoundError:
                print(f"Warning: split '{split}' not found, skipping")
        stats = dict(self.preprocessing_stats)
        stats["classes_found"] = sorted(stats["classes_found"])
        pre = Path(self.paths.preprocessed_dir)
        pre.mkdir(parents=True, exist_ok=True)
        with open(pre / "preprocessing_stats.json", "w", encoding="utf-8") as f:
            json.dump(stats, f, indent=2)
        (pre / FINGERPRINT_FILENAME).write_text(json.dumps(data_fingerprint(pre), indent=2))
        return results


# the reference's class name
MMEAPreprocessor = Preprocessor
