"""The reference's article workflow end to end on the hard fixture
(``scripts/article_workflow.py``): contrastive pretrain → linear probe and finetune →
few-shot grid, with a from-scratch control arm for every cell.

1. the hard fixture (class-overlapped IMU and video, label noise, cross-modal
   coupling) → preprocess;
2. cross-modal pretraining (SigLIP by default, ``--infonce`` for InfoNCE) on a separate,
   larger unlabeled pool, stopped when the val loss stops improving for
   ``--pretrain-patience`` epochs, with the pool's val pair retrieval as telemetry;
3. full-data probe: linear_probe and finetune from the pretrained encoder and from a
   random one;
4. few-shot grid (``run_parallel_fewshot``): n_samples × {linear_probe, finetune} ×
   runs, pretrained against scratch, mean ± std per cell and the per-cell delta.

Artifacts → ``--out``: ``article_workflow.json`` (the JAX script's schema),
``fewshot_pretrained_raw.csv``, ``fewshot_scratch_raw.csv``, ``summary.md``.

Runs on the card unless ``--cpu``; ``--quick`` is a test-scale pass:
``python -m tpuhar_torch.scripts.article_workflow [--quick] [--cpu]``
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ._common import log, script_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--classes", type=int, default=6)
    p.add_argument("--samples", type=int, default=14, help="sequences per class/split")
    p.add_argument("--resize", type=int, default=64)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--backbone", default="tpu_cnn")
    p.add_argument("--pretrain-epochs", type=int, default=30)
    # the pretraining pool's size (sequences per class, a separate draw, labels unused):
    # the reference's setting, pretraining on the full dataset and few-shot on scarce labels
    p.add_argument("--pretrain-samples", type=int, default=40)
    # stop a failing pretrain after this many epochs without a better val loss
    p.add_argument("--pretrain-patience", type=int, default=4)
    p.add_argument("--epochs", type=int, default=60, help="probe/finetune epochs")
    p.add_argument("--lr-encoder", type=float, default=3e-4)
    p.add_argument("--lr-head", type=float, default=1e-3)
    p.add_argument("--pretrain-lr", type=float, default=2e-4)
    p.add_argument("--few-shot-samples", default="2,5,10")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--label-noise", type=float, default=0.1)
    # instance-level cross-modal structure (video pulses at the sequence's IMU
    # frequency); without it the modalities share only the class
    p.add_argument("--no-coupling", dest="coupling", action="store_false")
    p.add_argument("--coupling-strength", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigmoid", action="store_true", default=True,
                   help="use SigLIP for pretraining (default)")
    p.add_argument("--infonce", dest="sigmoid", action="store_false",
                   help="use InfoNCE instead (stalls on this fixture at the "
                        "default batch/lr/temperature — kept for the record)")
    p.add_argument("--out", default="outputs/torch/docs/article_hard")
    p.add_argument("--workdir", default="outputs/torch/article_hard",
                   help="fixture + checkpoints live here (gitignored)")
    p.add_argument("--quick", action="store_true",
                   help="tiny smoke: 3 classes, few epochs")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def apply_quick(args) -> None:
    """``--quick``'s sizes and output directories (the JAX script's), in place; the
    device stays ``--cpu``'s."""
    if args.quick:
        args.classes, args.samples = 3, 6
        args.pretrain_epochs, args.epochs = 4, 3
        args.pretrain_samples = 8
        args.few_shot_samples, args.runs = "2,4", 2
        args.backbone, args.resize, args.frames = "tiny_cnn", 32, 2
        if args.out == "outputs/torch/docs/article_hard":  # keep the full run's artifact
            args.out = "outputs/torch/article_quick"
        if args.workdir == "outputs/torch/article_hard":
            args.workdir = "outputs/torch/article_quick_work"


def build_config(args, work: Path):
    from ..data.synthetic import generate_synthetic_dataset, make_synthetic_config

    log(f"generating hard fixture: {args.classes} classes × {args.samples} seqs/split, "
        f"label_noise={args.label_noise}")
    generate_synthetic_dataset(
        work / "data", num_classes=args.classes, samples_per_class=args.samples, seq_len=1500, seed=args.seed,
        difficulty="hard", label_noise=args.label_noise, cross_modal_coupling=args.coupling,
        coupling_strength=args.coupling_strength,
    )
    cfg = make_synthetic_config(
        work / "data", work / "out",
        num_classes=args.classes,
        video_backbone=args.backbone,
        video_resize=(args.resize, args.resize),
        pretrain_epochs=args.pretrain_epochs,
        train_epochs=args.epochs,
        pretrain_batch_size=64,
        train_batch_size=32,
        few_shot_samples=[int(s) for s in args.few_shot_samples.split(",")],
        few_shot_runs=args.runs,
    )
    cfg.data.video_frames_per_window = args.frames
    cfg.model.compute_dtype = "float32"
    cfg.model.head_norm = "layer"
    cfg.training.use_sigmoid_loss = bool(args.sigmoid)
    cfg.training.patience = args.epochs + 1  # matched budget, no early stop
    cfg.training.seed = args.seed
    cfg.training.pretrain_lr = args.pretrain_lr
    cfg.training.train_lr_encoder = args.lr_encoder
    cfg.training.train_lr_head = args.lr_head
    return cfg


def _pool_retrieval(cfg, out: Path, device) -> dict:
    """Pair-retrieval accuracy of the cross-modal model trained under the output root
    ``out`` on its val split: the pretraining telemetry that a falling loss cannot fake
    (a pretrain that learned the coupling retrieves the matching clip far above 1/N)."""
    from ..bridge import init_params
    from ..cli import Pipeline
    from ..data.loader import create_dataloaders
    from ..models.crossmodal import CrossModalModel
    from ..ops.video import normalize_clip
    from ..train import checkpoint as ckpt
    from ..train.factory import build_crossmodal_task

    pipe = Pipeline(cfg, device=device)
    val_df = pipe._metadata("val")
    loaders = create_dataloaders(cfg, val_df, val_df, val_df, mode="cross_modal", device=device)
    task = build_crossmodal_task(cfg, 1, init_params(cfg, torch.Generator().manual_seed(0), CrossModalModel), device=device)
    ckpt.restore_checkpoint(Path(out) / "checkpoints" / "cross_modal" / "best_model", task.state)
    model = task.model.eval()

    ip, vp = [], []
    with torch.inference_mode():
        for b in loaders["train"]:
            out = model.forward_cast(b["imu"], normalize_clip(b["video"]), train=False)
            n = int(b["n_valid"])
            ip.append(out["imu_proj"].float().cpu().numpy()[:n])
            vp.append(out["video_proj"].float().cpu().numpy()[:n])
    I, V = np.concatenate(ip), np.concatenate(vp)
    S = I @ V.T
    order = np.argsort(-S, axis=1)
    top1 = float((order[:, 0] == np.arange(len(S))).mean())
    top5 = float((order[:, :5] == np.arange(len(S))[:, None]).any(1).mean())
    return {
        "pairs": int(len(S)),
        "retrieval_top1": round(top1, 4),
        "retrieval_top5": round(top5, 4),
        "chance": round(1.0 / len(S), 5),
        "emb_std_imu": round(float(I.std(0).mean()), 5),
        "emb_std_video": round(float(V.std(0).mean()), 5),
    }


def write_pool(args, work: Path, device):
    """The unlabeled pretraining pool under ``work / "pool"``: a fresh draw (seed + 1000)
    of the same hard distribution, so that no labeled-fixture sequence leaks in. Returns
    its ``Pipeline`` (``pool/out``), whose ``run_preprocessing`` writes the windows that
    pretraining and ``debug_pretrain_parity`` read."""
    from ..cli import Pipeline
    from ..data.synthetic import generate_synthetic_dataset, make_synthetic_config

    pool = work / "pool"
    log(f"generating pretrain pool: {args.classes} classes × {args.pretrain_samples} seqs/split (labels unused)")
    generate_synthetic_dataset(
        pool / "data", num_classes=args.classes, samples_per_class=args.pretrain_samples, seq_len=1500,
        seed=args.seed + 1000, difficulty="hard", label_noise=0.0, cross_modal_coupling=args.coupling,
        coupling_strength=args.coupling_strength,
    )
    cfg = make_synthetic_config(
        pool / "data", pool / "out",
        num_classes=args.classes,
        video_backbone=args.backbone,
        video_resize=(args.resize, args.resize),
        pretrain_epochs=args.pretrain_epochs,
        pretrain_batch_size=64,
    )
    cfg.data.video_frames_per_window = args.frames
    cfg.model.compute_dtype = "float32"
    cfg.model.head_norm = "layer"
    cfg.training.use_sigmoid_loss = bool(args.sigmoid)
    cfg.training.pretrain_lr = args.pretrain_lr
    cfg.training.seed = args.seed
    cfg.training.patience = args.pretrain_patience
    return Pipeline(cfg, device=device)


def pretrain_on_pool(args, work: Path, device):
    """Pretrain on the pool ``write_pool`` writes; returns the IMU encoder's parameters
    and the run's telemetry."""
    pool = work / "pool"
    pipe = write_pool(args, work, device)
    cfg = pipe.config
    t0 = time.perf_counter()
    pipe.run_preprocessing()
    pipe.run_pretraining()
    enc_params, _ = pipe._load_pretrained_encoder()
    if enc_params is None:
        raise RuntimeError("pool pretraining produced no encoder checkpoint")
    # the val loss's trajectory tells learning from pair memorization
    hist_path = pool / "out" / "checkpoints" / "cross_modal" / "training_history.json"
    hist = json.loads(hist_path.read_text()) if hist_path.exists() else {}
    epochs_ran = len(hist.get("train", []))
    info = {
        "wall_s": round(time.perf_counter() - t0, 1),
        "pool_samples_per_class": args.pretrain_samples,
        "epochs_ran": epochs_ran,
        "train_loss": [round(float(x), 3) for x in hist.get("train", [])],
        "val_loss": [round(float(x), 3) for x in hist.get("val", [])],
    }
    if epochs_ran and epochs_ran < args.pretrain_epochs:
        info["early_stopped"] = (
            f"val loss stopped improving for {args.pretrain_patience} epochs "
            f"(ran {epochs_ran}/{args.pretrain_epochs})"
        )
        log(f"pretrain early-stopped: {info['early_stopped']}")
    info["val_retrieval"] = _pool_retrieval(cfg, pool / "out", device)
    log(f"pool val retrieval: {info['val_retrieval']}")
    return enc_params, info


def full_data_arm(cfg, dfs, enc_params, mode: str, tag: str, generator, device):
    """One full-data classifier (probe or finetune); returns its test metrics."""
    from ..data.loader import create_dataloaders
    from ..eval.evaluator import Evaluator, restore_best, train_classifier

    train_df, val_df, test_df = dfs
    loaders = create_dataloaders(cfg, train_df, val_df, test_df, mode="classification", device=device)
    task, trainer = train_classifier(
        cfg, mode, max(len(loaders["train"]), 1), loaders["train"], loaders["val"],
        Path(cfg.paths.checkpoints_dir) / f"article_{mode}_{tag}", generator=generator, device=device,
        encoder_params=enc_params,
    )
    restore_best(task, trainer)
    m = Evaluator(task, cfg).evaluate(loaders["test"])["metrics"]
    return {k: round(float(m[k]), 2) for k in ("balanced_accuracy", "accuracy", "f1_macro")}


def main(argv=None):
    from ..cli import Pipeline
    from ..eval.evaluator import FewShotEvaluator
    from ..eval.fewshot_parallel import run_parallel_fewshot
    from ..train.steps import precision_scope

    args = parse_args(argv)
    apply_quick(args)
    device = script_device(args.cpu)

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    cfg = build_config(args, work)
    result = {
        "resolved_args": {k: str(v) if isinstance(v, Path) else v for k, v in vars(args).items()},
        "resolved_training": {
            "pretrain_lr": cfg.training.pretrain_lr,
            "pretrain_batch_size": cfg.training.pretrain_batch_size,
            "train_batch_size": cfg.training.train_batch_size,
            "train_lr_encoder": cfg.training.train_lr_encoder,
            "train_lr_head": cfg.training.train_lr_head,
            "seed": cfg.training.seed,
            "compute_dtype": cfg.model.compute_dtype,
            "pretrain_matmul_precision": "float32 (explicit context)",
        },
        "fixture": {
            "difficulty": "hard", "coupled": bool(args.coupling),
            "classes": args.classes,
            "samples_per_class_split": args.samples,
            "label_noise": args.label_noise, "seed": args.seed,
        },
        "pretrain": {
            "loss": "siglip" if args.sigmoid else "infonce",
            "epochs": args.pretrain_epochs, "backbone": args.backbone,
            "clip": [args.frames, args.resize, args.resize],
        },
        "budget": {"epochs": args.epochs, "few_shot_runs": args.runs},
    }

    pipe = Pipeline(cfg, device=device)
    t0 = time.perf_counter()
    pipe.run_preprocessing()
    log(f"preprocessing done ({time.perf_counter() - t0:.0f}s)")

    # full f32 matmuls (TF32 off) for the pretraining stage only; the supervised arms
    # keep the default precision
    with precision_scope("float32"):
        enc_params, pt_info = pretrain_on_pool(args, work, device)
    result["pretrain"].update(pt_info)
    log(f"pool pretraining done ({pt_info['wall_s']}s; "
        f"val loss {pt_info['val_loss'][:2]}...{pt_info['val_loss'][-2:]})")

    dfs = (pipe._metadata("train"), pipe._metadata("val"), pipe._metadata("test"))

    # ---- full-data probe/finetune, both arms ------------------------------------------
    result["full_data"] = {}
    for mode in ("linear_probe", "finetune"):
        for tag, enc in (("pretrained", enc_params), ("scratch", None)):
            t0 = time.perf_counter()
            m = full_data_arm(cfg, dfs, enc, mode, tag, pipe._next_key(), device)
            m["wall_s"] = round(time.perf_counter() - t0, 1)
            result["full_data"][f"{mode}/{tag}"] = m
            log(f"full-data {mode}/{tag}: bal_acc={m['balanced_accuracy']:.2f} ({m['wall_s']}s)")

    # ---- few-shot grid, both arms -----------------------------------------------------
    train_df, val_df, test_df = dfs
    raws = {}
    for tag, enc in (("pretrained", enc_params), ("scratch", None)):
        t0 = time.perf_counter()
        raw = run_parallel_fewshot(
            cfg, enc, train_df, test_df, val_df, experiment_name=tag,
            generator=torch.Generator().manual_seed(args.seed + 100), device=device,
        )
        raw.to_csv(out / f"fewshot_{tag}_raw.csv", index=False)
        raws[tag] = raw
        log(f"few-shot grid [{tag}] done ({time.perf_counter() - t0:.0f}s)")

    evaluator = FewShotEvaluator(cfg, device=device)
    aggs = {tag: evaluator.aggregate_results(raw) for tag, raw in raws.items()}

    # per-cell pretrained-against-scratch deltas (the claim under test)
    cells = []
    for _, row in aggs["pretrained"].iterrows():
        n, mode = row["n_samples"], row["mode"]
        scratch = aggs["scratch"]
        srow = scratch[(scratch["n_samples"] == n) & (scratch["mode"] == mode)].iloc[0]
        cells.append({
            "n_samples": int(n), "mode": str(mode),
            "pretrained_mean": round(float(row["balanced_accuracy_mean"]), 2),
            "pretrained_std": round(float(row["balanced_accuracy_std"]), 2),
            "scratch_mean": round(float(srow["balanced_accuracy_mean"]), 2),
            "scratch_std": round(float(srow["balanced_accuracy_std"]), 2),
            "delta": round(float(row["balanced_accuracy_mean"] - srow["balanced_accuracy_mean"]), 2),
        })
    result["few_shot_cells"] = cells
    result["few_shot_mean_delta"] = round(float(np.mean([c["delta"] for c in cells])), 2)
    result["platform"] = device.type

    # ---- artifacts --------------------------------------------------------------------
    (out / "article_workflow.json").write_text(json.dumps(result, indent=1))
    lines = [
        "# Article workflow on the hard fixture (pretrain → probe → few-shot)",
        "",
        f"Fixture: {args.classes} classes, hard (overlapped), label_noise="
        f"{args.label_noise}; pretrain {result['pretrain']['loss']} "
        f"{args.pretrain_epochs} ep; budget {args.epochs} ep/cell, "
        f"{args.runs} runs.  Platform: {result['platform']}.",
        "",
        "## Full-data (balanced accuracy)",
        "",
        "| mode | pretrained | scratch | delta |",
        "|---|---|---|---|",
    ]
    for mode in ("linear_probe", "finetune"):
        p = result["full_data"][f"{mode}/pretrained"]["balanced_accuracy"]
        s = result["full_data"][f"{mode}/scratch"]["balanced_accuracy"]
        lines.append(f"| {mode} | {p:.2f} | {s:.2f} | {p - s:+.2f} |")
    lines += [
        "",
        "## Few-shot grid (balanced accuracy, mean ± std over runs)",
        "",
        "| n/class | mode | pretrained | scratch | delta |",
        "|---|---|---|---|---|",
    ]
    for c in cells:
        lines.append(
            f"| {c['n_samples']} | {c['mode']} | {c['pretrained_mean']:.2f} ± "
            f"{c['pretrained_std']:.2f} | {c['scratch_mean']:.2f} ± "
            f"{c['scratch_std']:.2f} | {c['delta']:+.2f} |"
        )
    lines.append("")
    lines.append(f"Mean few-shot delta: **{result['few_shot_mean_delta']:+.2f}** points.")
    (out / "summary.md").write_text("\n".join(lines))
    log(f"artifacts -> {out}/")
    print(json.dumps({
        "bench": "article_workflow_hard",
        "few_shot_mean_delta": result["few_shot_mean_delta"],
        "full_data": result["full_data"],
        "cells": cells,
    }))
    return result


if __name__ == "__main__":
    main()
