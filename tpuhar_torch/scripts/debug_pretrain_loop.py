"""The real ``Pipeline.run_pretraining`` on the pool, with a loss line per batch
(``scripts/debug_pretrain_loop.py``).

Where ``debug_pretrain_parity``'s arms learn and the pipeline's pretraining does not,
the difference lies inside the real call path. This runs that path on the article run's
pool configuration with ``CrossModalTrainer.train_epoch`` wrapped: the wrapper logs the
loss, the input shapes and the batch's keys of the first five batches of each epoch and
the epoch's mean, around the trainer's own epoch (its mesh placement and generator
included), and puts the method back when the stage ends. The pool's existing
``cross_modal`` checkpoint is first copied aside to ``cross_modal_article_r5``.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.debug_pretrain_loop [workdir=outputs/torch/article_hard_r5] [--cpu]``
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

from ._common import log, script_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("workdir", nargs="?", default="outputs/torch/article_hard_r5")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def run(work="outputs/torch/article_hard_r5", *, device, epochs: int = 2) -> dict:
    from ..cli import Pipeline
    from ..train.loop import CrossModalTrainer
    from .debug_pretrain_parity import parity_config

    pool = Path(work) / "pool"
    cfg = parity_config(pool)
    cfg.training.pretrain_epochs = epochs
    cfg.training.patience = 5

    # keep the article run's checkpoint for the record
    ck = pool / "out" / "checkpoints" / "cross_modal"
    if ck.exists() and not (ck.parent / "cross_modal_article_r5").exists():
        shutil.copytree(ck, ck.parent / "cross_modal_article_r5")

    train_epoch = CrossModalTrainer.train_epoch

    def instrumented(self, loader):
        losses, first, step = [], [], self.train_step

        def logged(state, batch, generator):
            state, metrics = step(state, batch, generator)
            loss = float(metrics["loss"])
            losses.append(loss)
            if len(first) < 5:
                first.append(round(loss, 4))
                log(f"  [instrument] batch {len(losses) - 1}: loss={loss:.4f} imu={tuple(batch['imu'].shape)} "
                    f"video={tuple(batch['video'].shape)} keys={sorted(batch.keys())}")
            return state, metrics

        self.train_step = logged
        try:
            mean = train_epoch(self, loader)
        finally:
            self.train_step = step
        log(f"  [instrument] epoch first5={first} mean={np.mean(losses):.4f}")
        return mean

    CrossModalTrainer.train_epoch = instrumented
    try:
        trainer = Pipeline(cfg, device=device).run_pretraining()
    finally:
        CrossModalTrainer.train_epoch = train_epoch
    hist = trainer.history
    out = {
        "bench": "pretrain_loop_instrumented",
        "train": [round(float(x), 4) for x in hist["train"]],
        "val": [round(float(x), 4) for x in hist["val"]],
    }
    print(json.dumps(out))
    return out


def main(argv=None):
    args = parse_args(argv)
    return run(args.workdir, device=script_device(args.cpu))


if __name__ == "__main__":
    main()
