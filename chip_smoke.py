"""Drive the PyTorch port (``tpuhar_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failed check raises and the exit code is non-zero:

1. the card (``nvidia-smi``) and the torch and CUDA versions;
2. the kernel build from ``tpuhar_torch/csrc/`` (nvcc, sm_90a), timed;
3. each hand kernel against its plain PyTorch version on the card, at the shapes the
   main path gives it, with both times (CUDA events, after warm-up);
4. the flagship bf16 fusion forward at full width (``entry.build_forward``) answering
   three batch-8 requests, with each kernel's launch count in that run;
5. the same parameters in f32 on the CPU (plain paths) at batch 2, against the card;
6. step time and inferences/s at batch 8 and batch 256.

The line before the last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script fails at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from tpuhar_torch import _ext
from tpuhar_torch.bridge import init_params
from tpuhar_torch.entry import build_forward, flagship_config
from tpuhar_torch.ops.conv3x3 import conv3x3_bn_act, conv3x3_bn_act_reference
from tpuhar_torch.ops.featurize import featurize_windows
from tpuhar_torch.ops.fused_window import featurize_windows_auto
from tpuhar_torch.ops.stem import to_patch_major

FEATURIZE_ATOL = 1e-5  # f32 in and out; only the order of the mean/var sums differs
CONV_RTOL = 2e-2  # bf16 out: |kernel - plain| / max |plain|
COSINE_MIN = 0.99  # bf16 on the card against f32 on the CPU, same parameters
# (frames, S, C, C_out, residual): the residual convs of batch 8 and 256 clips of
# 16 frames, and one shape whose last 128-row tile is ragged (M = 3·49 = 147)
CONV_SHAPES = [
    (128, 14, 256, 256, False), (128, 14, 256, 256, True), (128, 7, 512, 512, True),
    (4096, 14, 256, 256, False), (4096, 14, 256, 256, True), (4096, 7, 512, 512, True),
    (3, 7, 512, 512, True),
]
CONV_TIMED_SHAPE = (4096, 14, 256, 256, True)  # the s0 second conv at batch 256


def require_cuda() -> None:
    """Fail unless a CUDA device is present: the script never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` on the current stream, after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_featurizer(rng) -> dict:
    raw = torch.from_numpy(rng.normal(0, 8000, (256, 250, 6)).astype(np.float32)).cuda()
    cases = [
        {}, {"kernel_size": 1}, {"kernel_size": 4}, {"normalize": False},
        {"kernel_size": 1, "normalize": False, "racc": 100.0, "rgyro": 2.0},
        {"racc": 100.0, "rgyro": 2.0},
    ]
    worst = 0.0
    for kw in cases:
        err = (featurize_windows_auto(raw, **kw) - featurize_windows(raw, **kw)).abs().max().item()
        print(f"[kernel] fused_window (256, 250, 6) {kw or 'default'}: max abs diff {err:.3e}")
        if not err <= FEATURIZE_ATOL:
            raise AssertionError(f"fused_window {kw}: max abs diff {err} > {FEATURIZE_ATOL}")
        worst = max(worst, err)
    ms = cuda_ms(lambda: featurize_windows_auto(raw), 200)
    plain_ms = cuda_ms(lambda: featurize_windows(raw), 200)
    print(f"[kernel] fused_window (256, 250, 6): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "shape": "(256, 250, 6) f32"}


def check_conv3x3() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_abs = worst_rel = 0.0
    timed = None
    for n, s, c, c_out, has_res in CONV_SHAPES:
        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        x = torch.relu(randn(n, s, s, c)).to(torch.bfloat16)
        kernel = randn(3, 3, c, c_out, scale=(9 * c) ** -0.5).to(torch.bfloat16)
        scale = torch.rand(c_out, generator=gen, device="cuda") + 0.5
        bias = randn(c_out, scale=0.1)
        res = randn(n, s, s, c_out).to(torch.bfloat16) if has_res else None
        got = conv3x3_bn_act(x, kernel, scale, bias, residual=res)
        want = conv3x3_bn_act_reference(x, kernel, scale, bias, res)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = cuda_ms(lambda: conv3x3_bn_act(x, kernel, scale, bias, residual=res), 20)
        plain_ms = cuda_ms(lambda: conv3x3_bn_act_reference(x, kernel, scale, bias, res), 20)
        tflops = 2 * n * s * s * 9 * c * c_out / ms / 1e9
        name = f"({n}, {s}, {s}, {c})->{c_out} residual={has_res}"
        print(
            f"[kernel] conv3x3 {name}: max abs diff {err:.3e}, rel {rel:.3e}; "
            f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms"
        )
        if not rel <= CONV_RTOL:
            raise AssertionError(f"conv3x3 {name}: relative diff {rel} > {CONV_RTOL}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if (n, s, c, c_out, has_res) == CONV_TIMED_SHAPE:
            timed = {"ms": ms, "plain_ms": plain_ms}
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, **timed,
            "shape": "(4096, 14, 14, 256)->256 bf16 + residual"}


def request(seed: int, batch: int):
    """Seeded raw IMU counts and a uint8 clip, made patch-major on the host."""
    rng = np.random.default_rng(seed)
    imu = rng.normal(0, 8000.0, (batch, 250, 6)).astype(np.float32)
    clip = rng.integers(0, 256, (batch, 16, 224, 224, 3), dtype=np.uint8)
    return torch.from_numpy(imu), torch.from_numpy(to_patch_major(clip))


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()


def main() -> None:
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _ext.library()
    print(f"[build] {_ext.library_path().name} from tpuhar_torch/csrc: {time.perf_counter() - t0:.1f} s")

    kernels = {
        "fused_window": {
            "name": "fused_window", "route": "cuda",
            "source": "tpuhar_torch/csrc/fused_window.cu",
            "replaces": "tpuhar/ops/fused_window.py:93",
            **check_featurizer(np.random.default_rng(0)),
        },
        "conv3x3_bn_act": {
            "name": "conv3x3_bn_act", "route": "cuda",
            "source": "tpuhar_torch/csrc/conv3x3.cu",
            "replaces": "tpuhar/ops/conv3x3.py:142",
            **check_conv3x3(),
        },
    }

    cfg = flagship_config()
    fn, _ = build_forward(cfg, 8, device="cuda", seed=0)
    requests = [tuple(t.cuda() for t in request(100 + i, 8)) for i in range(3)]
    featurize_windows_auto.launches = 0
    conv3x3_bn_act.launches = 0
    outs = [fn(*r) for r in requests]
    torch.cuda.synchronize()
    kernels["fused_window"]["launches"] = featurize_windows_auto.launches
    kernels["conv3x3_bn_act"]["launches"] = conv3x3_bn_act.launches
    shapes = {"logits": (8, cfg.model.num_classes), "msp": (8,), "energy": (8,), "embeddings": (8, 2 * cfg.model.imu_d_model)}
    for i, out in enumerate(outs):
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
                raise AssertionError(f"request {i}: {key} {tuple(out[key].shape)} not finite {shape}")
    print(f"[slice] 3 requests of batch 8 answered; outputs {shapes}, all finite; "
          f"launches {({k: v['launches'] for k, v in kernels.items()})}")
    for name, k in kernels.items():
        if k["launches"] <= 0:
            raise AssertionError(f"the main path never launched {name}")

    ref_fn, _ = build_forward(
        flagship_config("float32"), 2, device="cpu",
        params=init_params(cfg, torch.Generator().manual_seed(0)),
    )
    imu, video = requests[0]
    ref = ref_fn(imu[:2].cpu(), video[:2].cpu())
    for key in ("logits", "embeddings"):
        got = outs[0][key][:2].float().cpu()
        diff, cos = (got - ref[key]).abs().max().item(), cosine(got, ref[key])
        print(f"[cross-check] {key}: card bf16 vs CPU f32 max abs diff {diff:.4e}, cosine {cos:.6f}")
        if not cos >= COSINE_MIN:
            raise AssertionError(f"{key}: cosine {cos} < {COSINE_MIN}")

    gen = torch.Generator(device="cuda").manual_seed(1)
    for batch in (8, 256):
        imu = torch.randn((batch, 250, 6), generator=gen, device="cuda") * 8000.0
        video = torch.randint(0, 256, (batch, 16, 14, 14, 768), generator=gen, device="cuda", dtype=torch.uint8)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: fn(imu, video), 20 if batch == 8 else 10)
        print(
            f"[timing] batch {batch}: step {ms:.3f} ms, {batch / ms * 1e3:.1f} inf/s, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})"
        )

    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
