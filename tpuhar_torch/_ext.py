"""Build and load the port's CUDA kernels.

The sources in ``csrc/*.cu`` have a plain C interface. At first use each is compiled
with ``nvcc`` for ``sm_90a`` (one process per source, all at once), and the objects
are linked into one shared library under ``_build/``, named by a hash of the sources
and the flags, and loaded with ``ctypes``: a changed source builds anew, an unchanged
one loads the library built before. Every entry point returns
``cudaGetLastError()`` after its launch; ``check`` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# entry point -> argtypes; every pointer and the stream are c_void_p, so a 64-bit
# address is never cut to a 32-bit int
SIGNATURES = {
    # raw, out, B, T, C, acc_scale, gyro_scale, median taps, tile, normalize, stream
    "tpuhar_fused_window": (_P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _P),
    # x, w, scale, bias, residual, out, M, S, C, C_out, relu, stream
    "tpuhar_conv3x3_bn_act": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # the same in f32: x, w_hi, w_lo, scale, bias, residual, out, M, S, C, C_out, relu,
    # stream
    "tpuhar_conv3x3_bn_act_f32_split": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w, scale, bias, out, M, K, C0, relu, int8_out, out_scale, stream
    "tpuhar_stem_u8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # x_q, w, scale, bias, out, M, K, C0, relu, int8_out, out_scale, stream
    "tpuhar_int8_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # x, w, scale, bias, residual, out, M, S, So, C, C_out, stride, pad_lo, relu,
    # res_scale, int8_out, out_scale, stream
    "tpuhar_conv3x3_i8": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _F, _P,
    ),
    # q, k, v, out, lse and out in f32 (both null on the serving path), B, H, N, sm_scale,
    # then the (batch, head, token) element strides of q, k, v and out (out in f32 has
    # out's), stream
    "tpuhar_flash_attn": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, *(_L,) * 12, _P),
    # q, k, v, dO, lse, di, dk, dv, B, H, N, sm_scale, then the (batch, head, token)
    # element strides of q, k, v, dO, dk and dv, stream
    "tpuhar_flash_bwd_dkv": (*(_P,) * 8, _I, _I, _I, _F, *(_L,) * 18, _P),
    # q, k, v, o (f32), dO, lse, di (written), dq, B, H, N, sm_scale, the strides of q, k,
    # v, o, dO and dq, stream
    "tpuhar_flash_bwd_dq": (*(_P,) * 8, _I, _I, _I, _F, *(_L,) * 18, _P),
    # the f32 forms: q, k, v, out, lse (null on the serving path; out is the f32 output the
    # dQ kernel reads), B, H, N, sm_scale, the strides of q, k, v and out, stream
    "tpuhar_flash_attn_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _F, *(_L,) * 12, _P),
    # the arguments of their bf16 forms
    "tpuhar_flash_bwd_dkv_f32": (*(_P,) * 8, _I, _I, _I, _F, *(_L,) * 18, _P),
    "tpuhar_flash_bwd_dq_f32": (*(_P,) * 8, _I, _I, _I, _F, *(_L,) * 18, _P),
}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if Path("/usr/local/cuda/bin/nvcc").exists() else None
    )
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path() -> Path:
    sources = sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD / f"libtpuhar_kernels_{digest.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first use."""
    so = library_path()
    if not so.exists():
        BUILD.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD) as tmpdir:
            # one nvcc per source, all at once, then one link: the build takes as long
            # as its slowest source, however many kernels the port holds
            objs, procs = [], []
            for src in sorted(CSRC.glob("*.cu")):
                obj = str(Path(tmpdir) / f"{src.stem}.o")
                cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )))
                objs.append(obj)
            failed = []
            for cmd, proc in procs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed (rc {proc.returncode}): {' '.join(cmd)}\n{err}")
            if failed:
                raise RuntimeError("\n".join(failed))
            tmp = str(Path(tmpdir) / so.name)
            cmd = [nvcc(), "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed (rc {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
                )
            os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.tpuhar_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpuhar_cuda_error_string.restype = ctypes.c_char_p
    lib.tpuhar_kernel_attributes.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.tpuhar_kernel_attributes.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        msg = library().tpuhar_cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status}: {msg}")


# the kernels whose compiled attributes ``tpuhar_kernel_attributes`` reads, by the names of
# csrc/kernel_table.cuh: the f32 flash forward (without and with its LSE), dQ and dK/dV
ATTRIBUTE_KERNELS = ("flash_attn_f32", "flash_attn_f32_stats", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
ATTRIBUTES = ("registers", "local_bytes", "static_shared_bytes", "max_dynamic_shared_bytes")


def kernel_attributes(name: str) -> dict:
    """The compiled attributes of kernel ``name`` (one of ``ATTRIBUTE_KERNELS``), read by
    ``cudaFuncGetAttributes`` over the built library: registers a thread, local (spill)
    bytes a thread, static shared memory, and the dynamic shared-memory limit its entry
    point set at its first launch (before that, the default). Raises ``ValueError`` for
    another name and ``RuntimeError`` without a CUDA device, before anything is built."""
    import torch

    if name not in ATTRIBUTE_KERNELS:
        raise ValueError(f"kernel_attributes: {name!r} is not one of {ATTRIBUTE_KERNELS}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel_attributes({name!r}) needs a CUDA device")
    out = (ctypes.c_int * len(ATTRIBUTES))()
    check(library().tpuhar_kernel_attributes(name.encode(), out), "tpuhar_kernel_attributes")
    return dict(zip(ATTRIBUTES, out))
