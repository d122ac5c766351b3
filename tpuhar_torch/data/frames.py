"""Frame banks (``tpuhar/data/frames.py``): random-access reads of the per-window JPEG
frames that the preprocessor cached, copied so that the port imports nothing of the
JAX package.

A split's bank is one ``{split}_frames.bin`` blob of JPEG frames and a ``(n_windows,
F, 2)`` int64 table ``{split}_frame_index.npy`` of each window's frames' ``(offset,
length)`` (``-1`` where a frame is missing). A ``.meta.json`` sidecar with
``bank_format_version`` 2 marks standard-colour JPEGs; a bank without it was written
before the channel-order fix and holds RGB under cv2's BGR label, so its frames are
served without the flip. The writer (``FrameBankWriter``) and the native batched JPEG
decoder are not ported (ROADMAP queue 1 item 8): frames decode through OpenCV.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np


class FrameBankReader:
    """Random-access JPEG frame reads from a split's frame bank (``os.pread``: safe from
    several threads)."""

    def __init__(self, bin_path, index_path):
        self.fd = os.open(str(bin_path), os.O_RDONLY)
        self.table = np.load(index_path)  # (N, F, 2)
        meta = Path(index_path).with_suffix(".meta.json")
        self.legacy_color = True
        if meta.exists():
            try:
                self.legacy_color = int(json.loads(meta.read_text()).get("bank_format_version", 1)) < 2
            except (ValueError, OSError):
                pass

    def __len__(self):
        return len(self.table)

    def has_frames(self, row: int) -> bool:
        return bool((self.table[row, :, 0] >= 0).any())

    def read_clip(self, row: int, resize_hw, *, backend: str = "auto", threads: int = 1) -> np.ndarray:
        """One window's cached frames → ``(F, H, W, 3)`` uint8 RGB, resized, black where
        a frame is missing or does not decode. ``backend`` "auto" and "cv2" decode frame
        by frame through OpenCV; "native" (the batched libjpeg decoder) is not ported.
        ``threads`` is the native decoder's and is not read here."""
        if backend == "native":
            raise NotImplementedError("the native JPEG decoder is not ported: ROADMAP queue 1 item 8 (orchestration)")
        if backend not in ("auto", "cv2"):
            raise ValueError(f"unknown backend {backend!r}")
        import cv2

        H, W = resize_hw
        F = self.table.shape[1]
        out = np.zeros((F, H, W, 3), dtype=np.uint8)
        for j in range(F):
            off, length = self.table[row, j]
            if off < 0:
                continue
            img = cv2.imdecode(np.frombuffer(os.pread(self.fd, int(length), int(off)), np.uint8), cv2.IMREAD_COLOR)
            if img is None:
                continue
            if img.shape[:2] != (H, W):
                img = cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR)
            out[j] = img if self.legacy_color else img[..., ::-1]
        return out

    def close(self):
        try:
            os.close(self.fd)
        except OSError:
            pass
