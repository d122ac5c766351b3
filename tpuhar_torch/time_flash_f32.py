"""Time the f32 flash kernels of several source trees in turns, on one CUDA device: the
forward at the serving shape (8, 12, 1568, 64), the forward with its log-sum-exp and both
backward kernels at the pretraining shape (16, 12, 1568, 64).

    python -m tpuhar_torch.time_flash_f32 parent=OTHER/tpuhar_torch/csrc change=tpuhar_torch/csrc

Each ``name=DIR`` names a ``csrc`` directory: its ``flash_attn_f32.cu`` and
``flash_attn_bwd_f32.cu`` are compiled together (with ``-Xptxas -v``: each f32 kernel's
registers, shared memory and spills are printed, and any C75xx note that ``ptxas``
serialized a kernel's ``wgmma``) into a library under ``_build/timing/``,
loaded with ``ctypes``, and their entry points are called on the same operands (views of
``(B, N, H·64)`` buffers, as the ViT hands them over). Each library's outputs are held
against the plain version in float64 (max |kernel − plain| / max |plain|) and against a
second call of their own (bit for bit). Then each kernel of each library is timed in
turns, in the order given and back (``A B B A``), ``--rounds`` times: CUDA events over 10
calls after 2 warm-up calls, one mean per turn. The first line is the card's name and
power limit as ``nvidia-smi`` gives them; the last is a JSON object of every turn's time.
Without a CUDA device it raises.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from . import _ext
from .ops.flash_lean import _grad_buffer, flash_lean_backward_reference, flash_lean_reference

SERVING, TRAINING = (8, 12, 1568), (16, 12, 1568)
SM_SCALE = 0.125
ENTRIES = ("tpuhar_flash_attn_f32", "tpuhar_flash_bwd_dq_f32", "tpuhar_flash_bwd_dkv_f32")


def build(name: str, csrc: Path) -> ctypes.CDLL:
    """The tree's two f32 flash sources compiled into ``_build/timing/libf32_<name>.so``."""
    out = _ext.BUILD / "timing"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"libf32_{name}.so"
    sources = [str(csrc / "flash_attn_f32.cu"), str(csrc / "flash_attn_bwd_f32.cu")]
    cmd = [_ext.nvcc(), *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(so), *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{proc.stderr}")
    kernel = None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:  # then its properties: stack and spills, registers
            kernel = next((k for k in ("bwd_dkv", "bwd_dq", "attn") if f"{k}_f32_kernel" in line), None)
        elif kernel and ("spill" in line or "registers" in line):
            print(f"[ptxas {name} {kernel}] {line.strip()}")
        if "C75" in line:  # ptxas serialized the wgmma of a kernel
            print(f"[ptxas {name}] {line.strip()}")
    lib = ctypes.CDLL(str(so))
    for entry in ENTRIES:
        getattr(lib, entry).argtypes = list(_ext.SIGNATURES[entry])
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def operands(shape, n: int, seed: int):
    B, H, N = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, N, H, 64), generator=gen, device="cuda").transpose(1, 2) for _ in range(n)]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="name=csrc directory")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_flash_f32 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = {}
    for spec in args.trees:
        name, _, path = spec.partition("=")
        libs[name] = build(name, Path(path))
    stream = torch.cuda.current_stream().cuda_stream

    def check(status: int, entry: str) -> None:
        if status != 0:
            raise RuntimeError(f"{entry}: CUDA error {status}")

    qs, ks, vs = operands(SERVING, 3, 0)
    q, k, v, dout = operands(TRAINING, 4, 1)

    def forward(lib, shape, stats: bool):
        a, b_, c = (qs, ks, vs) if shape == SERVING else (q, k, v)
        B, H, N = shape
        out = torch.empty((B, N, H, 64), device="cuda").transpose(1, 2)
        lse = torch.empty((B, H, N), device="cuda") if stats else None
        check(lib.tpuhar_flash_attn_f32(
            a.data_ptr(), b_.data_ptr(), c.data_ptr(), out.data_ptr(), lse.data_ptr() if stats else 0,
            B, H, N, SM_SCALE, *a.stride()[:3], *b_.stride()[:3], *c.stride()[:3], *out.stride()[:3], stream,
        ), "tpuhar_flash_attn_f32")
        return out, lse

    out, lse = forward(next(iter(libs.values())), TRAINING, True)
    B, H, N = TRAINING

    def dq_call(lib):
        dq, di = _grad_buffer(q), torch.empty_like(lse)
        check(lib.tpuhar_flash_bwd_dq_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq.data_ptr(), B, H, N, SM_SCALE,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *dout.stride()[:3],
            *dq.stride()[:3], stream,
        ), "tpuhar_flash_bwd_dq_f32")
        return dq, di

    di = dq_call(next(iter(libs.values())))[1]

    def dkv_call(lib):
        dk, dv = _grad_buffer(q), _grad_buffer(q)
        check(lib.tpuhar_flash_bwd_dkv_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), di.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, N, SM_SCALE,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3], stream,
        ), "tpuhar_flash_bwd_dkv_f32")
        return dk, dv

    want_fwd = flash_lean_reference(qs.double(), ks.double(), vs.double(), SM_SCALE)
    want_bwd = flash_lean_backward_reference(q.double(), k.double(), v.double(), dout.double(), SM_SCALE)
    for name, lib in libs.items():
        got = (forward(lib, SERVING, False)[0], dq_call(lib)[0], *dkv_call(lib))
        again = (forward(lib, SERVING, False)[0], dq_call(lib)[0], *dkv_call(lib))
        torch.cuda.synchronize()
        rel = [((g.double() - w).abs().max() / w.abs().max()).item() for g, w in zip(got, (want_fwd, *want_bwd))]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"[check {name}] against float64: out rel {rel[0]:.3e}, dq rel {rel[1]:.3e}, dk rel {rel[2]:.3e}, "
              f"dv rel {rel[3]:.3e}; repeat bit for bit: {same}")
    del want_fwd, want_bwd

    def ms(call, lib) -> float:
        for _ in range(2):
            call(lib)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            call(lib)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 10

    def product(shape):  # one (N, N, 64) product per (batch, head)
        b, h, n = shape
        return 2 * b * h * n * n * 64

    kernels = {
        "forward": (lambda lib: forward(lib, SERVING, False), 2 * product(SERVING)),
        "forward_stats": (lambda lib: forward(lib, TRAINING, True), 2 * product(TRAINING)),
        "dq": (dq_call, 3 * product(TRAINING)),  # S, dP, dQ
        "dkv": (dkv_call, 4 * product(TRAINING)),  # S, dP, dV, dK
    }
    times = {kernel: {name: [] for name in libs} for kernel in kernels}
    order = list(libs)
    for _ in range(args.rounds):
        for kernel, (call, flops) in kernels.items():
            for name in order + order[::-1]:
                t = ms(call, libs[name])
                times[kernel][name].append(t)
                print(f"[time] {kernel} {name}: {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s)")
    print(json.dumps({"serving": list(SERVING) + [64], "training": list(TRAINING) + [64], "ms": times}))


if __name__ == "__main__":
    main()
