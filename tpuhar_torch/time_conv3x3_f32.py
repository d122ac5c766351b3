"""Time the f32 fused conv of several source trees in turns, on one CUDA device, at the f32
flagship's full-width shapes (batch 256: 4096 frames of 14²×256 and 7²×512, with and
without the residual) and the dry run's 8×2²×256 with the residual.

    python -m tpuhar_torch.time_conv3x3_f32 parent=OTHER/tpuhar_torch/csrc change=tpuhar_torch/csrc

Each ``name=DIR`` names a ``csrc`` directory: its ``conv3x3_f32.cu`` is compiled on its
own (with ``-Xptxas -v``: each kernel's registers, spills and any note on serialized
``wgmma`` are printed) into a library under ``_build/timing/`` and loaded with ``ctypes``.
A library that exports ``tpuhar_conv3x3_bn_act_f32_split`` takes the weights as the two
split-TF32 halves, repacked on each call as the wrapper repacks them
(``ops/conv3x3.pack_conv3x3_f32``, inside the timed call); one that exports
``tpuhar_conv3x3_bn_act_f32`` (the FFMA form) takes the HWIO weights as they lie. Each
library's output is held against the plain version in float64 on the first 64 frames
(max |kernel − plain| / max |plain|). Then each shape is timed for each library in turns,
in the order given and back (``A B B A``), ``--rounds`` times: CUDA events over
``--iters`` calls (50 at the dry run's shape) after one warm-up call, one mean per turn;
``F.conv2d`` in f32 with TF32 off and on (the conv alone, no BN, residual or ReLU) once a
round. The first line is the card's name and power limit as ``nvidia-smi`` gives them;
the last is a JSON object of every turn's time. Without a CUDA device it raises.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from . import _ext
from .ops.conv3x3 import conv3x3_bn_act_reference, pack_conv3x3_f32

# (frames, S, C, C_out, residual), ReLU on: the f32 flagship's four convs at batch 256,
# then the dry run's
SHAPES = [(4096, 14, 256, 256, False), (4096, 14, 256, 256, True),
          (4096, 7, 512, 512, False), (4096, 7, 512, 512, True), (8, 2, 256, 256, True)]
CHECK_FRAMES = 64
SPLIT, FFMA = "tpuhar_conv3x3_bn_act_f32_split", "tpuhar_conv3x3_bn_act_f32"
_P, _I = ctypes.c_void_p, ctypes.c_int
FFMA_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]  # x, w (9C, C_out), ..., stream


def build(name: str, csrc: Path) -> tuple:
    """``csrc/conv3x3_f32.cu`` compiled alone into ``_build/timing/libconv3x3_f32_<name>.so``:
    ``(library, its entry point's name)``."""
    out = _ext.BUILD / "timing"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"libconv3x3_f32_{name}.so"
    cmd = [_ext.nvcc(), *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(so), str(csrc / "conv3x3_f32.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    for i, line in enumerate(lines):
        if "C75" in line:  # ptxas's notes on wgmma it had to serialize or wait for
            print(f"[ptxas {name}] {line.strip()}")
        elif "Compiling entry function" in line and "conv3x3" in line:  # then its properties
            print(f"[ptxas {name}] " + " | ".join(l.strip() for l in lines[i + 1:i + 4]))
    lib = ctypes.CDLL(str(so))
    entry = SPLIT if hasattr(lib, SPLIT) else FFMA
    fn = getattr(lib, entry)
    fn.argtypes = list(_ext.SIGNATURES[SPLIT]) if entry == SPLIT else FFMA_ARGTYPES
    fn.restype = ctypes.c_int
    return lib, entry


def case(frames: int, s: int, c: int, c_out: int, residual: bool, seed: int = 0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.relu(torch.randn((frames, s, s, c), generator=gen, device="cuda"))
    kernel = torch.randn((3, 3, c, c_out), generator=gen, device="cuda") * (9 * c) ** -0.5
    scale = torch.rand(c_out, generator=gen, device="cuda") + 0.5
    bias = torch.randn(c_out, generator=gen, device="cuda") * 0.1
    res = torch.randn((frames, s, s, c_out), generator=gen, device="cuda") if residual else None
    return x, kernel, scale, bias, res


def call(lib, entry: str, x, kernel, scale, bias, res) -> torch.Tensor:
    """One call as the wrapper makes it (the split form's repack included)."""
    n, s, _, c = x.shape
    c_out = kernel.shape[-1]
    out = torch.empty((n, s, s, c_out), device=x.device)
    weights = pack_conv3x3_f32(kernel) if entry == SPLIT else (kernel,)
    status = getattr(lib, entry)(
        x.data_ptr(), *(w.data_ptr() for w in weights), scale.data_ptr(), bias.data_ptr(),
        None if res is None else res.data_ptr(), out.data_ptr(), n * s * s, s, c, c_out, 1,
        torch.cuda.current_stream().cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"{entry}: CUDA error {status}")
    return out


def ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="name=csrc directory")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--iters", type=int, default=3, help="calls a turn at 4096 frames")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_conv3x3_f32 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = {}
    for spec in args.trees:
        name, _, path = spec.partition("=")
        libs[name] = build(name, Path(path))
        print(f"[build {name}] {libs[name][1]}")

    times = {}
    for frames, s, c, c_out, residual in SHAPES:
        shape = f"{frames}x{s}x{s}x{c}->{c_out}" + (" + residual" if residual else "")
        x, kernel, scale, bias, res = case(frames, s, c, c_out, residual)
        k = min(frames, CHECK_FRAMES)
        want = conv3x3_bn_act_reference(x[:k].double(), kernel.double(), scale, bias,
                                        None if res is None else res[:k].double(), True)
        for name, (lib, entry) in libs.items():
            got = call(lib, entry, x, kernel, scale, bias, res)[:k].double()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            print(f"[check {name}] {shape}: rel {rel:.3e} against float64 on the first {k} frames")
        del want
        iters = args.iters if frames >= 1024 else 50
        flops = 2 * frames * s * s * 9 * c * c_out
        times[shape] = {name: [] for name in libs}
        times[shape].update({"F.conv2d f32": [], "F.conv2d tf32": []})
        order = list(libs)
        xc, wc = x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                lib, entry = libs[name]
                t = ms(lambda: call(lib, entry, x, kernel, scale, bias, res), iters)
                times[shape][name].append(t)
                print(f"[time] {shape} {name}: {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s of f32 work)")
            for what, tf32 in (("F.conv2d f32", False), ("F.conv2d tf32", True)):
                torch.backends.cudnn.allow_tf32 = tf32
                t = ms(lambda: F.conv2d(xc, wc, padding=1), iters)
                torch.backends.cudnn.allow_tf32 = False
                times[shape][what].append(t)
                print(f"[time] {shape} {what}: {t:.4f} ms")
        pack = ms(lambda: pack_conv3x3_f32(kernel), iters)
        print(f"[time] {shape} pack_conv3x3_f32 alone (inside the split form's calls): {pack:.4f} ms")
        del x, res, xc
        torch.cuda.empty_cache()
    print(json.dumps({"ms": times}))


if __name__ == "__main__":
    main()
