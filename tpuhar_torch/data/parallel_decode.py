"""Clip decoding in a process pool (``tpuhar/data/parallel_decode.py``), for hosts with
many cores, where JPEG and mp4 decoding is CPU-bound and threads share the GIL.

``ProcessDecodePool`` is a long-lived pool of spawned processes (not forked: the parent
holds a CUDA context, which does not survive a fork). Each worker imports only
``tpuhar_torch.data`` modules (numpy, and torch through the package; OpenCV only where it
decodes with it), never touches CUDA, opens its own ``FrameBankReader`` per bank (file
descriptors do not survive pickling) and takes plain-dict task specs.

Enabled by ``data.decode_processes > 0`` or ``BatchLoader(..., decode_processes=N)``. The
IMU side stays in process: it is a gather from a memory-mapped bank.
"""
from __future__ import annotations

import multiprocessing as mp
from concurrent import futures
from typing import Dict, List, Optional, Tuple

import numpy as np

# the worker process's readers: {(bin_path, idx_path): FrameBankReader}
_READERS: Dict = {}


def _get_reader(bin_path: str, idx_path: str):
    key = (bin_path, idx_path)
    reader = _READERS.get(key)
    if reader is None:
        from .frames import FrameBankReader

        reader = _READERS[key] = FrameBankReader(bin_path, idx_path)
    return reader


def decode_task(spec: Dict) -> Tuple[int, Optional[np.ndarray]]:
    """Decode one clip in a worker; ``spec`` is picklable plain data:

    - ``kind="bank"``: cached JPEG frames: ``bin_path``, ``idx_path``, ``row``,
      ``resize_hw`` and optionally ``backend`` and ``threads`` (``read_clip``'s);
    - ``kind="video"``: one online mp4 decode: ``path``, ``start_frame``,
      ``num_frames``, ``window_seconds``, ``fallback_fps``, ``resize_hw``;
    - ``kind="black"``: no video: ``None`` (the batch buffer is already zero).

    Returns ``(spec["i"], clip)``."""
    i = int(spec["i"])
    kind = spec["kind"]
    if kind == "black":
        return i, None
    if kind == "bank":
        reader = _get_reader(spec["bin_path"], spec["idx_path"])
        return i, reader.read_clip(int(spec["row"]), tuple(spec["resize_hw"]),
                                   backend=spec.get("backend", "auto"), threads=int(spec.get("threads", 1)))
    from .loader import decode_clip

    return i, decode_clip(
        spec["path"], int(spec["start_frame"]), num_frames=int(spec["num_frames"]),
        window_seconds=float(spec["window_seconds"]), fallback_fps=float(spec["fallback_fps"]),
        resize_hw=tuple(spec["resize_hw"]),
    )


class ProcessDecodePool:
    """A spawn-context process pool for clip decoding; start-up (each worker imports
    torch, about 1-2 s) is paid once per pool, over every epoch of its loader."""

    def __init__(self, workers: int):
        self.workers = int(workers)
        self._pool = futures.ProcessPoolExecutor(max_workers=self.workers, mp_context=mp.get_context("spawn"))

    def decode_batch(self, specs: List[Dict], out: np.ndarray) -> None:
        """Fill ``out[i]`` for each spec (a black clip's row stays zero)."""
        for i, clip in self._pool.map(decode_task, specs, chunksize=1):
            if clip is not None:
                out[i] = clip

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __del__(self):
        try:
            self._pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass
