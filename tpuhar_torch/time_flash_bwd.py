"""Time the flash-attention backward kernels of several source trees in turns, on one
CUDA device, at the pretraining shape (16, 12, 1568, 64).

    python -m tpuhar_torch.time_flash_bwd parent=OTHER/tpuhar_torch/csrc change=tpuhar_torch/csrc

Each ``name=DIR`` names a ``csrc`` directory: its ``flash_attn_bwd.cu`` is compiled on
its own (with ``-Xptxas -v``: the dK/dV and dQ kernels' registers, spills and any note
on serialized ``wgmma`` are printed) into a library under ``_build/timing/``, loaded with
``ctypes``, and its two entry points are called on the same operands (views of
``(B, N, H·64)`` buffers, as the ViT hands them over; the forward's ``lse`` and f32
output from this tree's forward kernel). Each library's dq, dk and dv are held against
autograd through the plain attention (max |kernel − plain| / max |plain|) and against a
second call of their own (bit for bit). Then each kernel of each library is timed in
turns, in the order given and back (``A B B A``), ``--rounds`` times: CUDA events over 20
calls after 3 warm-up calls, one mean per turn. The first line is the card's name and
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
from .ops.flash_lean import _grad_buffer, flash_lean_backward_reference, flash_lean_with_stats

SHAPE = (16, 12, 1568)
SM_SCALE = 0.125


def build(name: str, csrc: Path) -> ctypes.CDLL:
    """``csrc/flash_attn_bwd.cu`` compiled alone into ``_build/timing/lib<name>.so``."""
    out = _ext.BUILD / "timing"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{name}.so"
    cmd = [_ext.nvcc(), *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(so), str(csrc / "flash_attn_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    for i, line in enumerate(lines):
        if "C75" in line:  # ptxas's notes on wgmma it had to serialize or wait for
            print(f"[ptxas {name}] {line.strip()}")
        elif "Compiling entry function" in line and "flash_bwd_d" in line:  # then its properties
            kernel = "dkv" if "dkv" in line else "dq"
            print(f"[ptxas {name} {kernel}] " + " | ".join(l.strip() for l in lines[i + 1:i + 4]))
    lib = ctypes.CDLL(str(so))
    for entry in ("tpuhar_flash_bwd_dkv", "tpuhar_flash_bwd_dq"):
        getattr(lib, entry).argtypes = list(_ext.SIGNATURES[entry])
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="name=csrc directory")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_flash_bwd needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = {}
    for spec in args.trees:
        name, _, path = spec.partition("=")
        libs[name] = build(name, Path(path))

    B, H, N = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (
        torch.randn((B, N, H, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
        for _ in range(4)
    )
    _, lse, out_f32 = flash_lean_with_stats(q, k, v, SM_SCALE)
    want = flash_lean_backward_reference(q, k, v, dout, SM_SCALE)
    stream = torch.cuda.current_stream().cuda_stream

    def check(status: int, entry: str) -> None:
        if status != 0:
            raise RuntimeError(f"{entry}: CUDA error {status}")

    def dq_call(lib):
        dq, di = _grad_buffer(q), torch.empty_like(lse)
        check(lib.tpuhar_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out_f32.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq.data_ptr(), B, H, N, SM_SCALE,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out_f32.stride()[:3], *dout.stride()[:3],
            *dq.stride()[:3], stream,
        ), "tpuhar_flash_bwd_dq")
        return dq, di

    di = dq_call(next(iter(libs.values())))[1]

    def dkv_call(lib):
        dk, dv = _grad_buffer(q), _grad_buffer(q)
        check(lib.tpuhar_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), di.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, N, SM_SCALE,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3], stream,
        ), "tpuhar_flash_bwd_dkv")
        return dk, dv

    for name, lib in libs.items():
        got = (dq_call(lib)[0], *dkv_call(lib))
        again = (dq_call(lib)[0], *dkv_call(lib))
        torch.cuda.synchronize()
        rel = [((g.float() - w.float()).abs().max() / w.float().abs().max()).item() for g, w in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"[check {name}] dq rel {rel[0]:.3e}, dk rel {rel[1]:.3e}, dv rel {rel[2]:.3e}, "
              f"repeat bit for bit: {same}")

    def ms(call, lib) -> float:
        for _ in range(3):
            call(lib)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call(lib)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20

    product = 2 * B * H * N * N * 64  # one (N, N, 64) product per (batch, head)
    kernels = {"dkv": (dkv_call, 4 * product), "dq": (dq_call, 3 * product)}  # S, dP, dV, dK; S, dP, dQ
    times = {kernel: {name: [] for name in libs} for kernel in kernels}
    order = list(libs)
    for _ in range(args.rounds):
        for kernel, (call, flops) in kernels.items():
            for name in order + order[::-1]:
                t = ms(call, libs[name])
                times[kernel][name].append(t)
                print(f"[time] {kernel} {name}: {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s)")
    print(json.dumps({"shape": list(SHAPE) + [64], "ms": times}))


if __name__ == "__main__":
    main()
