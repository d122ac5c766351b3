"""Raw-input serving streams (``tpuhar/data/raw_stream.py``): a manifest → batches of raw
IMU counts (and uint8 clips), what ``serving.InferenceEngine.predict_stream`` takes.

The engine featurizes raw counts itself, while the manifest indexes featurized windows,
so ``RawWindowReader`` cuts each window out of its sensor CSV again, as the
preprocessor sliced it (``window_idx * imu_stride``, a short tail zero-padded). Clips
come through ``loader.BatchLoader(mode="fusion")`` (frame bank, else the clip's one seek
and read); its featurized ``"imu"`` is dropped. pandas is imported by the caller that
builds the DataFrame, not here.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


class RawWindowReader:
    """Raw ``(window, channels)`` count windows out of the sensor CSVs, each file parsed
    once."""

    def __init__(self, config, base_input=None):
        self.d = config.data
        self.base = Path(base_input) if base_input is not None else Path(config.paths.base_input)
        self._cache: Dict[str, np.ndarray] = {}

    def window(self, row) -> np.ndarray:
        path = str(self.base / row.sensor_path)
        if path not in self._cache:
            self._cache[path] = np.loadtxt(path, delimiter=",", dtype=np.float32)
        size = int(self.d.imu_window_size)
        start = int(row.window_idx) * int(self.d.imu_stride)
        w = self._cache[path][start: start + size]
        if len(w) < size:  # the preprocessor zero-pads short sequences
            w = np.pad(w, ((0, size - len(w)), (0, 0)))
        return w


def raw_serving_stream(
    config,
    df,
    *,
    batch_size: int,
    with_video: bool = True,
    base_input=None,
    max_windows: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """``(imu_raw (B, window, 6) f32, video (B, T, H, W, 3) uint8)`` batches, or
    ``(imu_raw,)`` without video, in manifest order; the last batch may be short.
    ``max_windows`` stops after the batch that reaches it."""
    from .loader import BatchLoader

    reader = RawWindowReader(config, base_input)
    df = df.reset_index(drop=True)
    served = 0
    if not with_video:
        for start in range(0, len(df), batch_size):
            if max_windows is not None and served >= max_windows:
                return
            imu = np.stack([reader.window(r) for r in df.iloc[start: start + batch_size].itertuples()])
            served += len(imu)
            yield (imu,)
        return

    loader = BatchLoader(df, config, mode="fusion", batch_size=batch_size, prefetch=2)
    i = 0
    for batch in loader:
        n = int(batch.get("n_valid", len(batch["video"])))
        rows = df.iloc[i: i + n]
        i += n
        imu = np.stack([reader.window(r) for r in rows.itertuples()])
        yield imu, np.asarray(batch["video"])[:n]
        served += n
        if max_windows is not None and served >= max_windows:
            return
