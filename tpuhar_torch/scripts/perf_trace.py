"""A profiler trace of the flagship serving step and its top device ops
(``scripts/perf_trace.py``).

``capture`` runs ``entry.build_forward(flagship_config())`` (the tower given as the
first argument, default ``tpu_cnn``) at batch 256 on device-resident inputs twice
untraced, then ``steps`` steps under ``utils/profiling.trace``, which writes the Chrome
trace ``<logdir>/trace.json``. ``summarize`` prints the device ops of those steps by
self time, with their launches a step (``profile_step.summarize_events``, the table of
``profile_step.device_profile``), and the device busy share.

Runs on the card unless ``--cpu`` (then the host ops' self time):
``python -m tpuhar_torch.scripts.perf_trace [backbone] [--logdir DIR] [--cpu]``
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ._common import card_line, log, script_device, serving_inputs

LOGDIR = "outputs/torch/perf_trace"
BATCH, STEPS, TOP = 256, 3, 30


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("backbone", nargs="?", default=None, help="the video tower (default: the flagship's tpu_cnn)")
    p.add_argument("--logdir", default=LOGDIR)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def capture(logdir, device, *, backbone=None, batch: int = BATCH, steps: int = STEPS, config=None):
    """The profiler of ``steps`` traced steps, its trace written to ``logdir``."""
    import copy

    from ..entry import build_forward, flagship_config
    from ..utils.profiling import trace

    cfg = copy.deepcopy(config) if config is not None else flagship_config()
    if backbone:
        cfg.model.video_backbone = backbone
    fn, example = build_forward(cfg, batch, device=device, seed=0)
    args = serving_inputs(example, device)
    for _ in range(2):
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
    with trace(logdir) as prof:
        for _ in range(steps):
            fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize()
    return prof


def summarize(prof, steps: int, device, top: int = TOP) -> dict:
    """The top ``top`` ops of the trace by self time, a step."""
    from ..profile_step import summarize_events

    table = summarize_events(prof.events(), steps, device=device)
    for r in table["rows"][:top]:
        log(f"{r['ms']:10.4f} ms  x{r['launches']:<6.1f} {r['name'][:100]}")
    log(f"device {table['device_ms']:.4f} ms a step in {table['ops']:.0f} ops, busy {100 * table['busy']:.1f}%")
    return {**{k: table[k] for k in ("device_ms", "ops", "busy")}, "top": table["rows"][:top]}


def run(backbone=None, *, cpu: bool = False, logdir=LOGDIR, batch: int = BATCH, steps: int = STEPS, top: int = TOP,
        config=None) -> dict:
    """``{"bench": "trace", "backbone", "batch", "steps", "trace", "device", "device_ms",
    "ops", "busy", "top"}`` (``config`` default: ``entry.flagship_config()``)."""
    from ..utils.profiling import TRACE_FILENAME

    device = script_device(cpu)
    card = card_line(device)
    prof = capture(logdir, device, backbone=backbone, batch=batch, steps=steps, config=config)
    result = {"bench": "trace", "backbone": backbone or "tpu_cnn", "batch": batch, "steps": steps,
              "trace": str(Path(logdir) / TRACE_FILENAME), "device": card, **summarize(prof, steps, device, top)}
    log(f"trace written to {result['trace']} ({card})")
    print(json.dumps(result))
    return result


def main(argv=None):
    args = parse_args(argv)
    return run(args.backbone, cpu=args.cpu, logdir=args.logdir)


if __name__ == "__main__":
    main()
