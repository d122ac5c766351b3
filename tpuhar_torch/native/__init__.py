"""The batched libjpeg frame decoder (``tpuhar/native/__init__.py``): a host library,
not a device kernel.

``decode.c`` is compiled at first use with the system's C compiler (``$CC``, else
``cc``) and libjpeg into ``tpuhar_torch/_build/``, under a name that holds a hash of the
source and the command: a changed source builds anew, an unchanged one loads the library
built before. Each process compiles to a name of its own and renames the result into
place, so concurrent workers never load a half-written file. Where no compiler or no
libjpeg is present, ``decode_available()`` is False and ``decode_jpeg_bank`` returns
None; ``data/frames.FrameBankReader`` then decodes through OpenCV, except under
``backend="native"``, which raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "decode.c"
BUILD = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O2", "-shared", "-fPIC")
_LIBS = ("-ljpeg", "-lpthread")
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    """Where the decoder's shared library is (or would be) built."""
    digest = hashlib.sha256(" ".join((*_FLAGS, *_LIBS)).encode())
    digest.update(_SRC.read_bytes())
    return BUILD / f"libtpuhar_decode_{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    """Compile ``decode.c`` into ``so``; False where the compiler or libjpeg fails."""
    if so.exists():
        return True
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [os.environ.get("CC", "cc"), *_FLAGS, str(_SRC), "-o", str(tmp), *_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, so)  # atomic within the directory
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)
    return so.exists()


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = library_path()
        if not _build(so):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _build_failed = True
            return None
        lib.tpuhar_decode_jpeg_bank.restype = ctypes.c_int
        lib.tpuhar_decode_jpeg_bank.argtypes = [
            ctypes.c_char_p,  # blob
            ctypes.POINTER(ctypes.c_longlong),  # offsets
            ctypes.POINTER(ctypes.c_longlong),  # lengths
            ctypes.c_int,  # n
            ctypes.POINTER(ctypes.c_ubyte),  # out
            ctypes.c_int, ctypes.c_int,  # H, W
            ctypes.c_int,  # threads
        ]
        _lib = lib
        return _lib


def decode_available() -> bool:
    """True when the decoder built and loaded (a C compiler and libjpeg are present)."""
    return _load() is not None


def decode_jpeg_bank(blob: bytes, offsets: np.ndarray, lengths: np.ndarray, H: int, W: int, *,
                     out: Optional[np.ndarray] = None, threads: int = 1) -> Optional[np.ndarray]:
    """Decode the ``n`` JPEGs at ``(offsets[i], lengths[i])`` in ``blob`` into ``(n, H, W,
    3)`` uint8 RGB; ``lengths[i] <= 0`` marks a gap, left black.

    Returns None when the decoder is unavailable or any image fails to decode or is not
    ``(H, W, 3)``. ``out``, if given, must be C-contiguous uint8 ``(n, H, W, 3)`` (checked:
    the C side writes ``n·H·W·3`` bytes). ``threads > 1`` decodes on that many threads."""
    lib = _load()
    if lib is None:
        return None
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    n = int(len(offs))
    if out is None:
        out = np.zeros((n, H, W, 3), dtype=np.uint8)
    else:
        if out.shape != (n, H, W, 3) or out.dtype != np.uint8:
            raise ValueError(f"out must be uint8 {(n, H, W, 3)}, got {out.dtype} {out.shape}")
        if not out.flags.c_contiguous:
            raise ValueError("out must be C-contiguous")
        out[lens <= 0] = 0
    rc = lib.tpuhar_decode_jpeg_bank(
        blob,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        int(H), int(W), int(threads),
    )
    return out if rc == 0 else None
