"""The weakest learnable cross-modal coupling strength, gated on pair retrieval
(``scripts/probe_coupling_strength.py``).

At strength 1 the hard fixture's cross-modal pulse is too faint for either contrastive
loss to learn in the article workflow's budget. This sweep generates a small coupled
pool per strength (and frames per clip), pretrains the ``tiny_cnn`` tower at 32² for a
few epochs per (strength, loss) and measures the pool's val pair retrieval (the loss
value alone cannot tell learning from its absence). The weakest setting that retrieves
far above chance is the one to run the article workflow at.

Writes a markdown table to stderr and ``outputs/torch/docs/coupling_strength.json``.
Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.probe_coupling_strength [--cpu]``
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

from ._common import log, script_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def run(*, device, strengths=(2.0, 4.0, 8.0), frames=(8,), losses=("siglip", "infonce"), epochs: int = 4,
        samples_per_class: int = 8, root="outputs/torch/coupling_sweep",
        out="outputs/torch/docs/coupling_strength.json") -> dict:
    from ..cli import Pipeline
    from ..data.synthetic import generate_synthetic_dataset, make_synthetic_config
    from .article_workflow import _pool_retrieval

    root = Path(root)
    results = []
    for strength in strengths:
        for n_frames in frames:
            work = root / f"s{strength:g}_f{n_frames}"
            if work.exists():
                shutil.rmtree(work)
            generate_synthetic_dataset(
                work / "data", num_classes=6, samples_per_class=samples_per_class,
                seq_len=1500, seed=1000, difficulty="hard", label_noise=0.0,
                cross_modal_coupling=True, coupling_strength=strength,
            )
            for loss in losses:
                out_dir = work / f"out_{loss}"
                cfg = make_synthetic_config(
                    work / "data", out_dir,
                    num_classes=6, video_backbone="tiny_cnn",
                    video_resize=(32, 32), pretrain_epochs=epochs,
                    pretrain_batch_size=64,
                )
                cfg.data.video_frames_per_window = n_frames
                cfg.model.compute_dtype = "float32"
                cfg.model.head_norm = "layer"
                cfg.training.use_sigmoid_loss = loss == "siglip"
                cfg.training.pretrain_lr = 2e-4
                cfg.training.seed = 0
                pipe = Pipeline(cfg, device=device)
                pipe.run_preprocessing()
                trainer = pipe.run_pretraining()
                ret = _pool_retrieval(cfg, out_dir, device)
                results.append({
                    "strength": strength, "frames": n_frames, "loss": loss,
                    "train_loss": [round(float(x), 3) for x in trainer.history["train"]],
                    "val_loss": [round(float(x), 3) for x in trainer.history["val"]],
                    **ret,
                })
                log(f"strength={strength} frames={n_frames} loss={loss}: top1={ret['retrieval_top1']} "
                    f"(chance {ret['chance']}) top5={ret['retrieval_top5']}")

    log("\n| strength | frames | loss | top1 | top5 | chance |")
    log("|---|---|---|---|---|---|")
    for r in results:
        log(f"| {r['strength']} | {r['frames']} | {r['loss']} | {r['retrieval_top1']} | {r['retrieval_top5']} | "
            f"{r['chance']} |")
    rec = {"bench": "coupling_strength_sweep", "epochs": epochs, "results": results}
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return rec


def main(argv=None):
    return run(device=script_device(parse_args(argv).cpu))


if __name__ == "__main__":
    main()
