"""Frame banks (``tpuhar/data/frames.py``): the per-window JPEG frames the preprocessor
caches (``FrameBankWriter``) and their random-access reads (``FrameBankReader``), copied
so that the port imports nothing of the JAX package.

The writer decodes each video once, sequentially, and JPEG-encodes the union of its
windows' frames (``loader.clip_frame_indices``, the online decoder's selection), resized,
in the decoder's BGR order: the JPEGs have standard colours and the reader's one flip
gives RGB. A split's bank is one ``{split}_frames.bin`` blob of JPEG frames and a ``(n_windows,
F, 2)`` int64 table ``{split}_frame_index.npy`` of each window's frames' ``(offset,
length)`` (``-1`` where a frame is missing). A ``.meta.json`` sidecar with
``bank_format_version`` 2 marks standard-colour JPEGs; a bank without it was written
before the channel-order fix and holds RGB under cv2's BGR label, so its frames are
served without the flip. The reader decodes a clip in one call of the batched libjpeg
decoder (``tpuhar_torch.native``) where it builds, else frame by frame through OpenCV.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .loader import clip_frame_indices


class FrameBankWriter:
    """Appends one split's JPEG frames to ``bin_path``; ``finalize`` writes the
    per-window offset table and the v2 sidecar."""

    def __init__(self, bin_path, *, num_frames: int, resize_hw, jpeg_quality: int = 90):
        self.bin_path = Path(bin_path)
        self.bin_path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.bin_path, "wb")
        self._offset = 0
        self.num_frames = num_frames
        self.resize_hw = resize_hw
        self.jpeg_quality = jpeg_quality
        self.rows: List[np.ndarray] = []  # one (F, 2) per window, -1 where there is no frame

    def add_missing(self, n_windows: int = 1) -> None:
        """Windows without usable video: rows of -1 (the loader decodes or blacks them)."""
        for _ in range(n_windows):
            self.rows.append(np.full((self.num_frames, 2), -1, dtype=np.int64))

    def add_video(self, video_path, window_start_frames: List[int], *, window_seconds: float,
                  fallback_fps: float) -> None:
        """Every window's frames of one video in one sequential pass; a video that does
        not open, has no frames or fails to decode gives missing rows."""
        import cv2

        H, W = self.resize_hw
        try:
            cap = cv2.VideoCapture(str(video_path))
            if not cap.isOpened():
                cap.release()
                self.add_missing(len(window_start_frames))
                return
            total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 0
            fps = float(cap.get(cv2.CAP_PROP_FPS)) or 0.0
            if total <= 0:
                cap.release()
                self.add_missing(len(window_start_frames))
                return
            if fps <= 1e-6:
                fps = fallback_fps
            per_window = [
                clip_frame_indices(total, fps, sf, num_frames=self.num_frames, window_seconds=window_seconds)
                for sf in window_start_frames
            ]
            needed = np.unique(np.concatenate(per_window))
            entries: Dict[int, tuple] = {}
            pos = ni = 0
            while ni < len(needed):
                ret, frame = cap.read()
                if not ret or frame is None:
                    break
                if pos == needed[ni]:
                    bgr = frame  # imencode takes BGR: the JPEG keeps standard colours
                    if bgr.shape[:2] != (H, W):
                        bgr = cv2.resize(bgr, (W, H), interpolation=cv2.INTER_LINEAR)
                    ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, self.jpeg_quality])
                    if ok:
                        data = buf.tobytes()
                        self._f.write(data)
                        entries[pos] = (self._offset, len(data))
                        self._offset += len(data)
                    ni += 1
                pos += 1
            cap.release()
            for idx in per_window:
                row = np.full((self.num_frames, 2), -1, dtype=np.int64)
                for j, fi in enumerate(idx):
                    if int(fi) in entries:
                        row[j] = entries[int(fi)]
                self.rows.append(row)
        except Exception:
            self.add_missing(len(window_start_frames))

    def finalize(self, index_path) -> Optional[np.ndarray]:
        """Close the blob and write the ``(N, F, 2)`` table and its ``.meta.json`` sidecar
        (``bank_format_version`` 2: standard-colour JPEGs); with no window at all, remove
        the empty blob and return None."""
        self._f.close()
        if not self.rows:
            try:
                self.bin_path.unlink()
            except OSError:
                pass
            return None
        table = np.stack(self.rows)
        np.save(index_path, table)
        Path(index_path).with_suffix(".meta.json").write_text(
            json.dumps({"bank_format_version": 2, "color": "standard-jpeg"})
        )
        return table


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
        """One window's cached frames → ``(F, H, W, 3)`` uint8 RGB, black where a frame is
        missing.

        ``backend="auto"`` decodes the clip in one call of the native decoder
        (``tpuhar_torch.native``, ``threads`` threads) where it builds, the bank is not
        a legacy one and the stored frames are ``resize_hw``; otherwise frame by frame
        through OpenCV, which also resizes. ``"native"`` raises where the native path
        cannot decode the clip (it never falls back); ``"cv2"`` forces OpenCV."""
        if backend not in ("auto", "native", "cv2"):
            raise ValueError(f"unknown backend {backend!r}")
        H, W = resize_hw
        if backend != "cv2":
            clip = self._read_clip_native(row, H, W, threads)
            if clip is not None:
                return clip
            if backend == "native":
                raise RuntimeError(
                    f"native decode unavailable, legacy bank or stored frame size != {tuple(resize_hw)} "
                    "(see tpuhar_torch.native.decode_available())"
                )
        import cv2

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

    def _read_clip_native(self, row: int, H: int, W: int, threads: int) -> Optional[np.ndarray]:
        """The clip's present frames read into one buffer and decoded in one C call;
        None where the decoder is unavailable, the bank is legacy or a frame does not
        decode at ``(H, W)``."""
        from .. import native

        if self.legacy_color or not native.decode_available():
            return None
        entries = self.table[row]  # (F, 2) of (offset, length)
        parts = []
        offs = np.zeros(len(entries), np.int64)
        lens = np.zeros(len(entries), np.int64)
        pos = 0
        for j, (off, length) in enumerate(entries):
            if off < 0 or length <= 0:
                continue
            parts.append(os.pread(self.fd, int(length), int(off)))
            offs[j], lens[j] = pos, int(length)
            pos += int(length)
        return native.decode_jpeg_bank(b"".join(parts), offs, lens, H, W, threads=threads)

    def close(self):
        try:
            os.close(self.fd)
        except OSError:
            pass
