"""Matched-budget accuracy head-to-head: the video towers as fusion classifiers
(``scripts/bench_accuracy.py``).

Every tower trains the same ``FusionClassifier`` recipe with the same budget (epochs,
batch size, LR schedule, no early stopping) on the same preprocessed windows of the
synthetic fixture, then reports

- test balanced accuracy, accuracy and macro-F1 (full-class supervised fusion
  training), and
- leave-one-activity-out OOD AUROC and FPR@95 (MSP, energy and Mahalanobis on the fused
  embedding, ``OODEvaluator`` with ``model_kind="fusion"``).

Per tower it leaves ``<out>/<tower>/checkpoints/`` holding ``fusion_full/``,
``ood_loo_{c}/`` (the port's ``.pt`` checkpoints), ``config.json`` and the data
fingerprint: what ``validate_int8_ood`` and ``rescore_ood_hard`` read. The results merge
into ``<out>/results.json``; the JSON is the JAX script's.

Defaults run the flagship serving shape (16 × 224² clips) on the card; ``--quick``
shrinks everything (``--cpu`` picks the CPU):
``python -m tpuhar_torch.scripts.bench_accuracy [--backbones tpu_cnn,resnet18] [--quick] [--cpu]``
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path

import torch

from ._common import log, script_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--backbones", default="tpu_cnn,resnet18,videomae_small")
    p.add_argument("--classes", type=int, default=6)
    p.add_argument("--samples", type=int, default=12, help="sequences per class/split")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--resize", type=int, default=224)
    p.add_argument("--seq-len", type=int, default=1500, help="fixture sequence length")
    p.add_argument(
        "--difficulty", default="hard", choices=("easy", "hard"),
        help="fixture difficulty: 'hard' (default) overlaps classes so the "
        "head-to-head can fail; 'easy' gives the saturated fixture",
    )
    p.add_argument(
        "--label-noise", type=float, default=0.1,
        help="fraction of train windows with flipped labels (hard fixture)",
    )
    p.add_argument(
        "--freq-jitter", type=float, default=None,
        help="hard fixture per-sequence frequency jitter half-width in Hz "
        "(default 0.09; raise toward 0.15-0.20 for a mid-range landing)",
    )
    p.add_argument("--loo-classes", default="", help="comma list; empty = all")
    p.add_argument("--out", default="outputs/torch/bench_accuracy")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument("--quick", action="store_true", help="tiny smoke settings")
    p.add_argument("--skip-ood", action="store_true")
    p.add_argument(
        "--set", action="append", default=[], dest="overrides",
        help="config override applied to every tower, e.g. "
        "--set model.video_pretrained=true "
        "--set model.video_weights_path=/path/ckpt.bin (REAL_WEIGHTS.md)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="reuse completed checkpoints (fusion_full / ood_loo_{c} dirs with a "
        "training_history.json) instead of retraining — lets an interrupted run "
        "finish only its missing LOO classes",
    )
    return p.parse_args(argv)


def apply_quick(args) -> None:
    """``--quick``'s sizes (the JAX script's), in place; the device stays ``--cpu``'s."""
    if args.quick:
        args.classes = min(args.classes, 4)
        args.samples = min(args.samples, 4)
        args.epochs = min(args.epochs, 2)
        args.batch = min(args.batch, 8)
        args.frames = 4
        args.resize = 32
        args.seq_len = 600


def build_config(args, fixture, outroot, backbone, shared_preprocessed):
    from ..data.synthetic import make_synthetic_config

    cfg = make_synthetic_config(
        fixture, outroot,
        num_classes=args.classes,
        video_backbone=backbone,
        video_resize=(args.resize, args.resize),
        train_epochs=args.epochs,
        train_batch_size=args.batch,
    )
    cfg.data.video_frames_per_window = args.frames
    cfg.data.featurize_backend = "host"
    # matched budget: no early stopping, the same LR schedule for every tower
    cfg.training.patience = args.epochs + 1
    cfg.ood.model_kind = "fusion"
    if args.loo_classes:
        cfg.ood.leave_out_classes = [int(c) for c in args.loo_classes.split(",")]
    if args.quick:
        cfg.model.imu_num_layers = 1
        cfg.model.imu_d_model = 32
        cfg.model.imu_nhead = 4
        cfg.model.fusion_heads = 4
        cfg.model.video_d_model = 48
        cfg.model.compute_dtype = "float32"
    for override in getattr(args, "overrides", []):
        key, value = override.split("=", 1)
        cfg.override(key, value)
    # every tower scores the same preprocessed windows and frame bank
    cfg.paths.preprocessed_dir = Path(shared_preprocessed)
    cfg.paths.ensure_dirs()
    Path(shared_preprocessed).mkdir(parents=True, exist_ok=True)
    return cfg


def run_backbone(args, cfg, backbone, dfs, device):
    from ..bridge import init_params
    from ..data.loader import create_dataloaders
    from ..data.preprocess import FINGERPRINT_FILENAME, data_fingerprint
    from ..eval.evaluator import Evaluator
    from ..models.crossmodal import FusionClassifier
    from ..ood import OODEvaluator
    from ..train import checkpoint as ckpt
    from ..train.factory import build_fusion_task, task_generators
    from ..train.loop import ClassificationTrainer

    train_df, val_df, test_df = dfs
    result = {"backbone": backbone}

    # --resume reuses only checkpoints trained on byte-identical preprocessed data (the
    # shared directory is regenerated by every run)
    current_fp = data_fingerprint(cfg.paths.preprocessed_dir)
    tower_fp_path = Path(cfg.paths.checkpoints_dir) / FINGERPRINT_FILENAME
    if args.resume and tower_fp_path.exists():
        if json.loads(tower_fp_path.read_text()) != current_fp:
            log(
                f"[{backbone}] DATA FINGERPRINT MISMATCH: existing checkpoints were trained on a "
                "different regeneration of the shared preprocessed data — ignoring --resume and retraining"
            )
            args = copy.copy(args)
            args.resume = False

    # ---- full-class supervised fusion training ----------------------------------------
    loaders = create_dataloaders(cfg, train_df, val_df, test_df, mode="fusion", device=device)
    spe = max(len(loaders["train"]), 1)
    init_gen, fit_gen = task_generators(torch.Generator().manual_seed(args.seed), device)
    task = build_fusion_task(cfg, spe, init_params(cfg, init_gen, FusionClassifier), device=device)
    result["params_m"] = round(sum(p.numel() for p in task.model.parameters()) / 1e6, 2)

    t0 = time.perf_counter()
    full_dir = Path(cfg.paths.checkpoints_dir) / "fusion_full"
    if args.resume and (full_dir / "training_history.json").exists() and ckpt.checkpoint_exists(full_dir / "best_model"):
        log(f"[{backbone}] reusing completed fusion_full checkpoint")
    else:
        trainer = ClassificationTrainer(cfg, task.state, task.train_step, task.eval_step, full_dir, fit_gen, "finetune")
        task.state = trainer.fit(loaders["train"], loaders["val"])
    result["train_wall_s"] = round(time.perf_counter() - t0, 1)

    # the full-class training curve, so that the table ships with each tower's
    # plateau (or its absence) and not a bare endpoint
    hist_path = full_dir / "training_history.json"
    if hist_path.exists():
        hist = json.loads(hist_path.read_text())
        result["curve"] = {
            "train_loss": [round(float(e["loss"]), 4) for e in hist.get("train", [])],
            "train_acc": [round(float(e.get("accuracy", float("nan"))), 2) for e in hist.get("train", [])],
            "val_bal_acc": [
                round(float(e.get("balanced_accuracy", e.get("accuracy", float("nan")))), 2)
                for e in hist.get("val", [])
            ],
            "val_loss": [round(float(e["loss"]), 4) for e in hist.get("val", []) if "loss" in e],
        }

    best = full_dir / "best_model"
    if ckpt.checkpoint_exists(best):
        task.state, _ = ckpt.restore_checkpoint(best, task.state)
    test_out = Evaluator(task, cfg).evaluate(loaders["test"])
    for k in ("balanced_accuracy", "accuracy", "f1_macro"):
        result[f"test_{k}"] = round(float(test_out["metrics"][k]), 2)
    log(
        f"[{backbone}] full-class test bal_acc={result['test_balanced_accuracy']:.2f} "
        f"({result['train_wall_s']}s, {result['params_m']}M params)"
    )

    # ---- leave-one-activity-out OOD ----------------------------------------------------
    if not args.skip_ood:
        t0 = time.perf_counter()
        loo_cfg = copy.deepcopy(cfg)
        ood_df = OODEvaluator(loo_cfg, torch.Generator().manual_seed(args.seed + 1), device=device).run_loo_experiments(
            train_df, val_df, test_df, model_kind="fusion", reuse_checkpoints=args.resume,
        )
        result["ood_wall_s"] = round(time.perf_counter() - t0, 1)
        ood_df.to_csv(Path(cfg.paths.results_dir) / "ood_fusion_results.csv", index=False)
        for score, grp in ood_df.groupby("score"):
            result[f"auroc_{score}"] = round(float(grp["auroc"].mean()), 4)
            result[f"fpr95_{score}"] = round(float(grp["fpr_at_95tpr"].mean()), 4)
        result["ood_id_accuracy"] = round(float(ood_df["id_accuracy"].mean()), 2)
        log(f"[{backbone}] OOD mean AUROC: " + ", ".join(
            f"{s}={result[f'auroc_{s}']:.3f}" for s in sorted(set(ood_df["score"]))
        ))
    # bind this tower's checkpoints to the data they were trained and scored on, and
    # record the exact config, so that cross-run scorers rebuild the same model
    tower_fp_path.parent.mkdir(parents=True, exist_ok=True)
    tower_fp_path.write_text(json.dumps(current_fp, indent=2))
    cfg.save(Path(cfg.paths.checkpoints_dir) / "config.json")
    return result


def main(argv=None):
    from ..data.preprocess import Preprocessor
    from ..data.synthetic import generate_synthetic_dataset

    args = parse_args(argv)
    apply_quick(args)
    device = script_device(args.cpu)
    log(f"device: {device}")

    workdir = Path(args.out)
    fixture = workdir / "fixture"
    if not (fixture / "train.txt").exists():
        log(
            f"generating {args.difficulty} fixture: {args.classes} classes × "
            f"{args.samples} seqs/split, label_noise={args.label_noise}"
        )
        generate_synthetic_dataset(
            fixture, num_classes=args.classes, samples_per_class=args.samples,
            seq_len=args.seq_len, seed=args.seed, difficulty=args.difficulty,
            label_noise=args.label_noise if args.difficulty == "hard" else 0.0,
            freq_jitter=args.freq_jitter,
        )

    backbones = [b.strip() for b in args.backbones.split(",") if b.strip()]
    shared_pre = workdir / "preprocessed"
    # merge into the results.json an earlier run of other towers wrote
    results_path = workdir / "results.json"
    results = []
    if results_path.exists():
        try:
            results = [r for r in json.loads(results_path.read_text()) if r.get("backbone") not in backbones]
        except (json.JSONDecodeError, TypeError):
            results = []
    dfs = None
    for bb in backbones:
        cfg = build_config(args, fixture, workdir / bb, bb, shared_pre)
        if dfs is None:
            log("preprocessing (shared across towers)...")
            out = Preprocessor(cfg, device=device).run_full_preprocessing()
            dfs = (out["train"], out["val"], out["test"])
            log(f"windows: train={len(dfs[0])} val={len(dfs[1])} test={len(dfs[2])}")
        results.append(run_backbone(args, cfg, bb, dfs, device))
        results_path.write_text(json.dumps(results, indent=2))

    # markdown summary
    scores = sorted({k[len("auroc_"):] for r in results for k in r if k.startswith("auroc_")})
    hdr = ["tower", "params", "bal_acc", "f1"] + [f"AUROC {s}" for s in scores] + ["train s"]
    lines = ["| " + " | ".join(hdr) + " |", "|" + "---|" * len(hdr)]
    for r in results:
        row = [
            r["backbone"], f"{r.get('params_m', '?')}M",
            f"{r.get('test_balanced_accuracy', float('nan')):.2f}",
            f"{r.get('test_f1_macro', float('nan')):.2f}",
        ] + [f"{r.get(f'auroc_{s}', float('nan')):.3f}" for s in scores] + [str(r.get("train_wall_s", "?"))]
        lines.append("| " + " | ".join(row) + " |")
    table = "\n".join(lines)
    (workdir / "results.md").write_text(table + "\n")
    print(table)
    print(json.dumps({"bench": "accuracy_head_to_head", "results": results}))
    return results


if __name__ == "__main__":
    main()
