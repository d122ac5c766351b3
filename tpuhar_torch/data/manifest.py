"""Split-file parsing and the window-manifest schema (``tpuhar/data/manifest.py``),
copied so that the port imports nothing of the JAX package.

- split lines ``.../data/<class_dir>/<sample_prefix> <start> <end> <label>``;
- the per-window metadata CSV's columns (``METADATA_COLUMNS``, one row per window);
- few-shot sampling of k windows per class (``FewShotSampler``) and inverse-frequency
  class weights.

pandas is imported by the functions that take a DataFrame, not by the module.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

METADATA_COLUMNS = [
    "split",
    "class_dir",
    "class_name",
    "class_num",
    "label",
    "sample_id",
    "window_idx",
    "split_line",
    "sensor_path",
    "video_path",
    "video_exists",
    "start_frame",
    "imu_shape_0",
    "imu_shape_1",
    "split_start",
    "split_end",
    "imu_window_path",
    "bank_idx",  # the row in the packed {split}_windows.npy bank
]


@dataclass
class SampleInfo:
    """A parsed split line."""

    class_dir: str
    class_num: int
    class_name: str
    sample_prefix: str
    sensor_path: str
    video_path: str
    start: int
    end: int
    label: int


class SplitLineError(ValueError):
    """A malformed split line; callers count and skip it."""


def load_split_lines(config, split: str) -> List[str]:
    """The non-empty, non-comment lines of a split file."""
    names = {"train": config.paths.train_file, "val": config.paths.val_file, "test": config.paths.test_file}
    if split not in names:
        raise ValueError(f"Unknown split: {split}")
    split_file = Path(config.paths.base_input) / names[split]
    if not split_file.exists():
        raise FileNotFoundError(f"Split file not found: {split_file}")
    lines = []
    with open(split_file, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                lines.append(line)
    return lines


def parse_split_line(line: str) -> SampleInfo:
    """``.../data/<class_dir>/<prefix> start end label``: start and end swapped when
    reversed; the class directory split on its first underscore into ``<num>_<name>``
    (-1 for a non-numeric prefix); the sensor and video paths under ``sensor/`` and
    ``video/``."""
    toks = line.strip().split()
    if len(toks) < 4:
        raise SplitLineError(f"Invalid split line: {line}")
    path_token, start, end, label = toks[0], int(toks[1]), int(toks[2]), int(toks[3])
    if start > end:
        start, end = end, start
    parts = Path(path_token).parts
    if "data" not in parts:
        raise SplitLineError(f"No 'data' directory in: {line}")
    i = parts.index("data")
    if len(parts) < i + 3:
        raise SplitLineError(f"Expected .../data/<class>/<sample>: {line}")
    class_dir, sample_prefix = parts[i + 1], parts[i + 2]
    if "_" in class_dir:
        num_str, class_name = class_dir.split("_", 1)
        class_num = int(num_str) if num_str.isdigit() else -1
    else:
        class_num, class_name = -1, class_dir
    return SampleInfo(
        class_dir=class_dir,
        class_num=class_num,
        class_name=class_name,
        sample_prefix=sample_prefix,
        sensor_path=str(Path("sensor") / class_dir / f"{sample_prefix}.csv"),
        video_path=str(Path("video") / class_dir / f"{sample_prefix}.mp4"),
        start=start,
        end=end,
        label=label,
    )


def estimate_start_frame(window_idx: int, stride: float, sampling_rate: float, fps: float) -> int:
    """The video frame an IMU window starts at."""
    return int(round(window_idx * (stride / sampling_rate) * fps))


def window_record(
    split: str,
    info: SampleInfo,
    line: str,
    window_idx: int,
    video_exists: bool,
    window_shape,
    start_frame: int,
    imu_window_path: Optional[str] = None,
) -> Dict:
    """One manifest row, keyed as ``METADATA_COLUMNS``."""
    rec = {
        "split": split,
        "class_dir": info.class_dir,
        "class_name": info.class_name,
        "class_num": info.class_num,
        "label": info.label,
        "sample_id": info.sample_prefix,
        "window_idx": window_idx,
        "split_line": line,
        "sensor_path": info.sensor_path,
        "video_path": info.video_path,
        "video_exists": bool(video_exists),
        "start_frame": start_frame,
        "imu_shape_0": int(window_shape[0]),
        "imu_shape_1": int(window_shape[1]),
        "split_start": info.start,
        "split_end": info.end,
    }
    if imu_window_path is not None:
        rec["imu_window_path"] = str(imu_window_path)
    return rec


class FewShotSampler:
    """k windows of each class (all of a class's windows where it has fewer), drawn with
    ``DataFrame.sample(random_state=seed)`` class by class in order of appearance."""

    def __init__(self, metadata_df, config=None):
        self.df = metadata_df
        self.config = config

    def sample_k_per_class(self, k: int, seed: Optional[int] = None, verbose: bool = False):
        import pandas as pd

        if seed is not None:
            np.random.seed(seed)
        sampled = []
        for class_name in self.df["class_name"].unique():
            class_df = self.df[self.df["class_name"] == class_name]
            sampled.append(class_df.sample(n=k, random_state=seed) if len(class_df) >= k else class_df)
        result = pd.concat(sampled, ignore_index=True)
        if verbose:
            print(f"[FewShotSampler] {len(result)} samples ({k}/class × {self.df['class_name'].nunique()} classes)")
        return result

    def sample_balanced_test_set(self, n_per_class: int = 20, seed: Optional[int] = None):
        return self.sample_k_per_class(n_per_class, seed)


def get_class_weights(metadata_df) -> np.ndarray:
    """Inverse-frequency class weights, ``total / (classes · count)``, by sorted label."""
    counts = metadata_df["label"].value_counts().sort_index()
    return (len(metadata_df) / (len(counts) * counts.values)).astype(np.float32)
