"""Host data-feeding rates of ``data/loader.BatchLoader`` (``scripts/bench_loader.py``).

A synthetic fixture (8 classes × 6 sequences of 1500 samples, 224² video, the train
split) is written and preprocessed at 16 frames a clip under a temporary directory,
then the loader's rates are taken over its windows:

- IMU windows (``mode="classification"``, batch 64) from the packed bank and from
  per-file loads (the manifest without ``bank_idx``), after a pass that warms the page
  cache;
- cross-modal clips (``mode="cross_modal"``, batch 32) with 1 and 8 decode threads;
- cross-modal clips through the process pool, one rate per ``--workers=N`` (default
  2), the pool's start included.

The batches stay numpy on the host, as the JAX loader's do. Each rate is one pass timed
with ``profile_step.median_ms``. The fixture is preprocessed on the card unless
``--cpu``:
``python -m tpuhar_torch.scripts.bench_loader [--workers=N ...] [--cpu]``
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from pathlib import Path

from ._common import card_line, log, per_s, script_device

FIXTURE = dict(num_classes=8, samples_per_class=6, seq_len=1500, size=224, frames=16)
TRIALS = 1


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workers", type=int, action="append", default=None,
                   help="decode processes of one pool rate (repeatable; default 2)")
    p.add_argument("--cpu", action="store_true", help="preprocess on the CPU (default: the card)")
    return p.parse_args(argv)


def run(*, cpu: bool = False, workers=(2,), threads=(1, 8), num_classes: int = FIXTURE["num_classes"],
        samples_per_class: int = FIXTURE["samples_per_class"], seq_len: int = FIXTURE["seq_len"],
        size: int = FIXTURE["size"], frames: int = FIXTURE["frames"], trials: int = TRIALS) -> dict:
    """``{"bench", "windows", "fixture", "device", "imu_windows_per_s": {"bank",
    "per_file"}, "clips_per_s": {"threads_N", ..., "processes_N", ...}}``."""
    from ..data.loader import BatchLoader
    from ..data.preprocess import Preprocessor
    from ..data.synthetic import generate_synthetic_dataset, make_synthetic_config
    from ..profile_step import median_ms

    device = script_device(cpu)
    card = card_line(device)
    tmp = Path(tempfile.mkdtemp(prefix="tpuhar_torch_loaderbench_"))
    result = {"bench": "loader", "windows": None, "device": card,
              "fixture": dict(num_classes=num_classes, samples_per_class=samples_per_class, seq_len=seq_len,
                              size=size, frames=frames),
              "imu_windows_per_s": {}, "clips_per_s": {}}
    try:
        generate_synthetic_dataset(tmp / "data", num_classes=num_classes, samples_per_class=samples_per_class,
                                   seq_len=seq_len, video_size=(size, size), seed=0, splits=("train",))
        cfg = make_synthetic_config(tmp / "data", tmp / "out", num_classes=num_classes)
        cfg.data.video_resize = (size, size)
        cfg.data.video_frames_per_window = frames
        df = Preprocessor(cfg, device=device).preprocess_split("train", save=True)
        n = len(df)
        result["windows"] = n
        log(f"{n} windows")

        def rate(loader, warmup: int):
            return per_s(n, median_ms(lambda: sum(int(b["n_valid"]) for b in loader), (), trials=trials, iters=1,
                                      warmup=warmup, device=device))

        for label, frame in (("bank", df), ("per_file", df.drop(columns=["bank_idx"]))):
            loader = BatchLoader(frame, cfg, mode="classification", batch_size=64, prefetch=0)
            result["imu_windows_per_s"][label] = rate(loader, warmup=1)  # the warm-up pass fills the page cache
            log(f"imu {label:8}: {result['imu_windows_per_s'][label]} windows/s")
        for t in threads:
            loader = BatchLoader(df, cfg, mode="cross_modal", batch_size=32, prefetch=2, decode_workers=t)
            result["clips_per_s"][f"threads_{t}"] = rate(loader, warmup=0)
            log(f"clips ({t} decode threads): {result['clips_per_s'][f'threads_{t}']} clips/s")
        for p in workers:
            loader = BatchLoader(df, cfg, mode="cross_modal", batch_size=32, prefetch=2, decode_processes=p)
            try:
                result["clips_per_s"][f"processes_{p}"] = rate(loader, warmup=0)
            finally:
                loader.close()
            log(f"clips ({p} decode processes, the pool's start included): "
                f"{result['clips_per_s'][f'processes_{p}']} clips/s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"({card})")
    print(json.dumps(result))
    return result


def main(argv=None):
    args = parse_args(argv)
    return run(cpu=args.cpu, workers=tuple(args.workers or (2,)))


if __name__ == "__main__":
    main()
