"""Where the time of a serving step or of a training step goes, on one CUDA device.

    python -m tpuhar_torch.profile_step              # the four serving programs
    python -m tpuhar_torch.profile_step --pretrain   # the pretraining step
    python -m tpuhar_torch.profile_step --classify   # the classification steps
    python -m tpuhar_torch.profile_step --int8-towers  # the int8 ViT and ResNet-18

Builds the serving forwards from random weights of seed 0: the flagship's
``entry.build_forward`` (``bf16``) and ``entry.build_int8_forward`` in its
int8-resident (``int8_resident``) and baseline (``int8_baseline``) forms, and the
``videomae_base`` ViT forward ``entry.build_forward(vit_config())`` (``vit_bf16``).
Each is fed device-resident random inputs (a patch-major clip for the ``tpu_cnn``
programs, NHWC for the ViT), and for each program at batch 256 and 8 it prints:

- the step time without the profiler (CUDA events, the mean of 20 steps after 3
  warm-up steps) and the inferences per second;
- from ``torch.profiler`` over 5 steps: the device time per step of every
  kernel and copy by name, with its share and its launches per step; the device time
  per step; and the device busy share, the device time over the span from the first
  device op's start to the last one's end.

``--pretrain`` profiles the pretraining program instead (``pretrain``):
``entry.build_pretrain_task(pretrain_config())`` at batch 16 (the ``videomae_base``
cross-modal model, f32 master weights, bf16 compute, flash attention forward and
backward), one ``train_step`` a step (10 timed after 2 warm-up, then 3 profiled), with
the peak device memory and the flash backward kernels' share. ``--classify`` profiles
the classification stage's train steps the same way: the IMU classifier of
``entry.classify_config()`` at batch 64 in its linear probe and its finetune
(``imu_linear_probe``, ``imu_finetune``), and the fusion and video-only classifiers on
``pretrain_config()``'s ``videomae_base`` with the flash kernels at batch 16
(``fusion``, ``video``). ``--int8-towers`` profiles the int8 towers' serving forwards
(``entry.build_int8_forward``): the int8 ``videomae_base`` ViT of ``vit_config()``
(``int8_vit``) at batch 64 and 8, and the int8 ResNet-18 of ``pretrain_config()`` with
``resnet18`` in its resident and baseline forms (``int8_resnet18_resident``,
``int8_resnet18``) at batch 8, each on NHWC clips.

The first line is the card's name and power limit as ``nvidia-smi`` gives them.
Without a CUDA device it raises.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .bridge import init_params
from .entry import (
    build_classification_task,
    build_forward,
    build_fusion_task,
    build_int8_forward,
    build_pretrain_task,
    build_video_task,
    classify_config,
    flagship_config,
    pretrain_config,
    vit_config,
)

PROGRAMS = ("bf16", "int8_resident", "int8_baseline", "vit_bf16")
BATCHES = (256, 8)
STEPS = 5  # profiled steps, after the timed ones
TOP = 14  # rows of the per-kernel table; the rest are summed into one


def build(name: str, cfg, params) -> Callable:
    if name in ("bf16", "vit_bf16"):
        return build_forward(cfg, 8, device="cuda", params=params)[0]
    return build_int8_forward(cfg, 8, device="cuda", params=params, resident=name == "int8_resident")[0]


def step_ms(fn: Callable, args, iters: int = 20, warmup: int = 3, *, device="cuda") -> float:
    """Mean ms per step after ``warmup`` steps: CUDA events on the current stream, or the
    host clock where ``device`` is the CPU."""
    for _ in range(warmup):
        fn(*args)
    if torch.device(device).type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_ms(fn: Callable, args, *, trials: int = 3, iters: int = 20, warmup: int = 3,
              device="cuda") -> Optional[float]:
    """The median of ``trials`` runs of ``step_ms`` (the first after ``warmup`` steps), or
    None when no trial ran: a run that timed nothing reports no time."""
    times = [step_ms(fn, args, iters, warmup if i == 0 else 0, device=device) for i in range(trials)]
    return float(np.median(times)) if times else None


def device_profile(fn: Callable, args, steps: int) -> Dict:
    """Per-name device time of ``steps`` steps under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn(*args)
        torch.cuda.synchronize()
    return summarize_events(prof.events(), steps)


def summarize_events(events, steps: int, *, device="cuda") -> Dict:
    """``device_profile``'s table over a profiler's ``events()``: each name's time a
    step, share and launches a step, sorted by time; the device time a step, its ops a
    step and the busy share (device time over the span of the device ops). On the CPU
    each host op counts its self time."""
    from torch.autograd import DeviceType

    cpu = torch.device(device).type == "cpu"
    ops = [e for e in events if e.device_type == (DeviceType.CPU if cpu else DeviceType.CUDA)]
    if not ops:
        raise RuntimeError(f"torch.profiler recorded no {'host' if cpu else 'device'} ops")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in ops:
        by_name[e.name][0] += e.self_cpu_time_total if cpu else e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    device_us = sum(t for t, _ in by_name.values())
    span_us = max(e.time_range.end for e in ops) - min(e.time_range.start for e in ops)
    rows = sorted(
        ({"name": n, "ms": t / steps / 1e3, "share": t / device_us, "launches": c / steps}
         for n, (t, c) in by_name.items()),
        key=lambda r: -r["ms"],
    )
    return {"device_ms": device_us / steps / 1e3, "ops": len(ops) / steps,
            "busy": device_us / span_us, "rows": rows}


def print_profile(name: str, batch: int, ms: float, prof: Dict, steps: int, smi: str, unit: str = "inf/s") -> None:
    print(f"\n[{name} batch {batch}] step {ms:.3f} ms unprofiled, {batch / ms * 1e3:.1f} {unit}; "
          f"device {prof['device_ms']:.3f} ms/step in {prof['ops']:.0f} ops, busy "
          f"{100 * prof['busy']:.1f}% ({steps} profiled steps; {smi})")
    for r in prof["rows"][:TOP]:
        print(f"  {100 * r['share']:5.1f}%  {r['ms']:8.3f} ms  {r['launches']:5.1f}x  {r['name'][:100]}")
    rest = prof["rows"][TOP:]
    if rest:
        print(f"  {100 * sum(r['share'] for r in rest):5.1f}%  {sum(r['ms'] for r in rest):8.3f} ms"
              f"  {sum(r['launches'] for r in rest):5.1f}x  the other {len(rest)} names")


def train_batch(cfg, batch: int, *, labels: bool = False) -> Dict[str, torch.Tensor]:
    """A device-resident training batch of ``cfg``: z-scored IMU windows, a uint8 NHWC
    clip and, with ``labels``, class labels."""
    d = cfg.data
    H, W = d.video_resize
    gen = torch.Generator(device="cuda").manual_seed(1)
    data = {
        "imu": torch.randn((batch, d.imu_channels, d.imu_window_size), generator=gen, device="cuda"),
        "video": torch.randint(0, 256, (batch, d.video_frames_per_window, H, W, 3),
                               generator=gen, device="cuda", dtype=torch.uint8),
    }
    if labels:
        data["label"] = torch.randint(0, cfg.model.num_classes, (batch,), generator=gen, device="cuda")
    return data


def profile_train(name: str, task, data: Dict[str, torch.Tensor], smi: str) -> None:
    """One ``train_step`` a step on ``data``: step time (10 timed after 2 warm-up),
    samples/s, peak memory and the device profile (3 steps), with the flash kernels'
    share."""
    dropout = torch.Generator(device="cuda").manual_seed(0)

    def step(b):
        task.train_step(task.state, b, dropout)

    batch = data["imu"].shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ms = step_ms(step, (data,), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = device_profile(step, (data,), 3)
    print_profile(name, batch, ms, prof, 3, smi, unit="samples/s")
    bwd = [r for r in prof["rows"] if "flash_bwd" in r["name"]]
    fwd = [r for r in prof["rows"] if "flash_attn_kernel" in r["name"]]
    print(f"[{name} batch {batch}] peak memory {peak:.2f} GiB ({held / 2**30:.2f} GiB held before the steps); "
          f"flash backward kernels {sum(r['ms'] for r in bwd):.3f} ms/step "
          f"({100 * sum(r['share'] for r in bwd):.1f}% of device time, {sum(r['launches'] for r in bwd):.0f} "
          f"launches), flash forward {sum(r['ms'] for r in fwd):.3f} ms/step ({sum(r['launches'] for r in fwd):.0f} "
          f"launches)")


def profile_pretrain(smi: str, batch: int = 16) -> None:
    """The pretraining step at ``batch``."""
    cfg = pretrain_config()
    task = build_pretrain_task(cfg, device="cuda", seed=0, steps_per_epoch=100)
    profile_train("pretrain", task, train_batch(cfg, batch), smi)


def profile_classify(smi: str) -> None:
    """The classification stage's train steps: the IMU classifier's probe and finetune at
    its ``train_batch_size`` (64), the fusion and video classifiers at 16."""
    cfg = classify_config()
    for mode in ("linear_probe", "finetune"):
        task = build_classification_task(cfg, mode, device="cuda", steps_per_epoch=100)
        profile_train(f"imu_{mode}", task, train_batch(cfg, cfg.training.train_batch_size, labels=True), smi)
        del task
    cfg = pretrain_config()
    for name, build_task in (("fusion", build_fusion_task), ("video", build_video_task)):
        task = build_task(cfg, device="cuda", steps_per_epoch=100)
        profile_train(name, task, train_batch(cfg, 16, labels=True), smi)
        del task
        torch.cuda.empty_cache()


def profile_int8_towers(smi: str) -> None:
    """The int8 towers' serving forwards on device-resident NHWC clips."""
    from .models.crossmodal import FusionClassifier

    gen = torch.Generator(device="cuda").manual_seed(1)
    resnet = pretrain_config()
    resnet.model.video_backbone = "resnet18"
    programs = [("int8_vit", vit_config(), None, (64, 8)), ("int8_resnet18_resident", resnet, True, (8,)),
                ("int8_resnet18", resnet, False, (8,))]
    for name, cfg, resident, batches in programs:
        params = init_params(cfg, torch.Generator().manual_seed(0), FusionClassifier)
        fn = build_int8_forward(cfg, 8, device="cuda", params=params, resident=resident)[0]
        d = cfg.data
        H, W = d.video_resize
        for batch in batches:
            inputs = (
                torch.randn((batch, d.imu_window_size, d.imu_channels), generator=gen, device="cuda") * 8000.0,
                torch.randint(0, 256, (batch, d.video_frames_per_window, H, W, 3),
                              generator=gen, device="cuda", dtype=torch.uint8),
            )
            ms = step_ms(fn, inputs, iters=5 if batch > 8 else 20)
            print_profile(name, batch, ms, device_profile(fn, inputs, 2 if batch > 8 else STEPS),
                          2 if batch > 8 else STEPS, smi)
        del fn
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    """``argv``: the command-line arguments (none: the serving programs)."""
    parser = argparse.ArgumentParser(description="Profile a serving or training step on one CUDA device.")
    parser.add_argument("--pretrain", action="store_true", help="profile the pretraining step instead")
    parser.add_argument("--classify", action="store_true", help="profile the classification steps instead")
    parser.add_argument("--int8-towers", action="store_true", help="profile the int8 ViT and ResNet-18 instead")
    args = parser.parse_args([] if argv is None else argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    if args.pretrain:
        profile_pretrain(smi)
        return
    if args.classify:
        profile_classify(smi)
        return
    if args.int8_towers:
        profile_int8_towers(smi)
        return

    configs = {"flagship": flagship_config(), "vit": vit_config()}
    params = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name in PROGRAMS:
        kind = "vit" if name == "vit_bf16" else "flagship"
        cfg = configs[kind]
        if kind not in params:
            params[kind] = init_params(cfg, torch.Generator().manual_seed(0))
        fn = build(name, cfg, params[kind])
        d = cfg.data
        H, W = d.video_resize
        clip = (H, W, 3) if kind == "vit" else (H // 16, W // 16, 768)
        for batch in BATCHES:
            inputs = (
                torch.randn((batch, d.imu_window_size, d.imu_channels), generator=gen, device="cuda") * 8000.0,
                torch.randint(0, 256, (batch, d.video_frames_per_window, *clip),
                              generator=gen, device="cuda", dtype=torch.uint8),
            )
            ms = step_ms(fn, inputs)
            print_profile(name, batch, ms, device_profile(fn, inputs, STEPS), STEPS, smi)
        del fn
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
