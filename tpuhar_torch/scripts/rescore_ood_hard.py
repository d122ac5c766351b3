"""Rescore trained hard-fixture leave-one-out checkpoints with every OOD score (MSP,
energy, Mahalanobis, kNN, relative Mahalanobis): forward passes only, no training
(``scripts/rescore_ood_hard.py``).

Every scorer is fitted on id-train embeddings served through the same forward that
scores the ID and OOD test windows. Also temperature-calibrated MSP and energy
(``msp_cal``/``energy_cal``): the temperature fitted by NLL on the ID val split
(``eval/calibration.fit_temperature``, never test data) and applied as ``logits / T``,
what ``InferenceEngine(temperature=T)`` serves; the ID-test ECE before and after beside
it. The rows merge into an existing ``--out`` (a partial rescore keeps the other
towers' rows); the JSON is the JAX script's.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.rescore_ood_hard [--root outputs/torch/bench_accuracy_hard]
[--towers tpu_cnn,resnet18,videomae_small] [--classes 0,2,4] [--cpu]``
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path

import numpy as np
import torch

from ._common import find_checkpoint, fusion_model, log, restore_fusion_variables, score_split, script_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="outputs/torch/bench_accuracy_hard")
    p.add_argument("--towers", default="tpu_cnn,resnet18,videomae_small")
    p.add_argument("--classes", default="0,2,4")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--knn-k", type=int, default=10)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument(
        "--limit", type=int, default=0,
        help="cap windows per split (CPU smoke only — AUROCs are not comparable)",
    )
    p.add_argument("--out", default="outputs/torch/docs/ood_rescore_hard.json")
    p.add_argument(
        "--allow-data-mismatch", action="store_true",
        help="skip the checkpoint↔data fingerprint check",
    )
    return p.parse_args(argv)


def load_config(root: Path, tower: str, batch: int):
    """The recorded training config, or ``bench_accuracy``'s construction by convention."""
    from ..config import Config
    from ..data.synthetic import make_synthetic_config

    saved = root / tower / "checkpoints" / "config.json"
    if saved.exists():
        cfg = Config.load(saved)
    else:
        cfg = make_synthetic_config(
            root / "fixture", root / tower, num_classes=6, video_backbone=tower,
            video_resize=(224, 224), train_batch_size=batch,
        )
        cfg.data.video_frames_per_window = 16
    cfg.data.featurize_backend = "host"
    cfg.paths.preprocessed_dir = root / "preprocessed"
    return cfg


SCORE_NAMES = ["msp", "energy", "mahalanobis", "knn", "rmd"]
CAL_NAMES = ["msp_cal", "energy_cal"]


def rescore_class(args, cfg, dfs, tower: str, c: int, device):
    """One tower's held-out class: its row, or ``None`` without a checkpoint."""
    from ..eval.calibration import expected_calibration_error, fit_temperature
    from ..eval.metrics import auroc
    from ..ood import (
        KNNScorer,
        MahalanobisScorer,
        RelativeMahalanobisScorer,
        compute_ood_scores,
        energy_score,
        fpr_at_tpr,
        leave_one_out_split,
        msp_score,
    )
    from ..ops.video import normalize_clip

    # "last" first: the trainer's fit returns the last epoch's state, which is what the
    # head-to-head evaluator scored (validate_int8_ood)
    loo_dir = Path(args.root) / tower / "checkpoints" / f"ood_loo_{c}"
    ckpt_path = find_checkpoint(loo_dir, ("last", "best_model"))
    if ckpt_path is None:
        log(f"[{tower}] missing checkpoint under {loo_dir} — skipping")
        return None
    t0 = time.perf_counter()
    id_train, _, remap = leave_one_out_split(dfs["train"], c)
    id_val, _, _ = leave_one_out_split(dfs["val"], c, remap=remap)
    id_test, ood_test, _ = leave_one_out_split(dfs["test"], c, remap=remap)
    loo_cfg = copy.deepcopy(cfg)
    loo_cfg.model.num_classes = len(remap)
    model = fusion_model(loo_cfg, restore_fusion_variables(loo_cfg, ckpt_path), device)

    def forward(imu, video_u8):
        return model(imu, normalize_clip(video_u8))

    if args.limit:
        id_train, id_val, id_test, ood_test = (df.head(args.limit) for df in (id_train, id_val, id_test, ood_test))
    tr_lg, tr_em, tr_y, val_lg, _, val_y, id_lg, id_em, id_y, ood_lg, ood_em, _ = (
        x for df in (id_train, id_val, id_test, ood_test)
        for x in score_split(df, loo_cfg, forward, args.batch, device, labels=True)
    )
    C = len(remap)
    scorers = dict(
        mahalanobis=MahalanobisScorer.fit(tr_em, tr_y, C),
        knn=KNNScorer.fit(tr_em, k=args.knn_k),
        rmd=RelativeMahalanobisScorer.fit(tr_em, tr_y, C),
    )
    et = cfg.ood.energy_temperature
    id_s, ood_s = (
        compute_ood_scores(lg, em, scores=SCORE_NAMES, energy_temperature=et, **scorers)
        for lg, em in ((id_lg, id_em), (ood_lg, ood_em))
    )
    # calibrated msp/energy: T fitted by NLL on the ID val split served through the same
    # forward, the InferenceEngine(temperature=T) semantics
    temp = fit_temperature(val_lg, val_y)
    for s, lg in (("id", id_lg), ("ood", ood_lg)):
        scores = id_s if s == "id" else ood_s
        scaled = torch.from_numpy(lg / temp)
        scores["msp_cal"] = msp_score(scaled).numpy()
        scores["energy_cal"] = energy_score(scaled, et).numpy()
    row = {
        "tower": tower, "held_out_class": c,
        "temperature": round(float(temp), 3),
        "ece_id": round(expected_calibration_error(id_lg, id_y)["ece"], 4),
        "ece_id_cal": round(expected_calibration_error(id_lg / temp, id_y)["ece"], 4),
    }
    for name in SCORE_NAMES + CAL_NAMES:
        s = np.concatenate([id_s[name], ood_s[name]])
        is_ood = np.concatenate([np.zeros(len(id_s[name])), np.ones(len(ood_s[name]))])
        row[f"auroc_{name}"] = round(float(auroc(s, is_ood)), 4)
        row[f"fpr95_{name}"] = round(float(fpr_at_tpr(s, is_ood)), 4)
    row["wall_s"] = round(time.perf_counter() - t0, 1)
    log(
        f"[{tower}] class {c}: T={row['temperature']} ece {row['ece_id']}→{row['ece_id_cal']}  "
        + "  ".join(f"{n}={row[f'auroc_{n}']}" for n in SCORE_NAMES + CAL_NAMES)
        + f"  ({row['wall_s']}s)"
    )
    return row


def main(argv=None):
    import pandas as pd

    from ..data.preprocess import FINGERPRINT_FILENAME, verify_data_fingerprint

    args = parse_args(argv)
    device = script_device(args.cpu)
    log(f"device: {device}")
    root = Path(args.root)
    dfs = {split: pd.read_csv(root / "preprocessed" / f"{split}_metadata.csv") for split in ("train", "val", "test")}
    towers = args.towers.split(",")
    all_rows = []
    for tower in towers:
        # refuse to score checkpoints against data they were not trained on
        if not args.allow_data_mismatch:
            verify_data_fingerprint(
                root / tower / "checkpoints" / FINGERPRINT_FILENAME, root / "preprocessed",
                context=f"{tower} checkpoints",
            )
        cfg = load_config(root, tower, args.batch)
        for c in [int(x) for x in args.classes.split(",")]:
            row = rescore_class(args, cfg, dfs, tower, c, device)
            if row is not None:
                all_rows.append(row)

    # merge with an existing artifact: a partial rescore (--towers resnet18) keeps the
    # other towers' rows of the shared file
    out_path = Path(args.out)
    rescored = set(towers)
    prev_rows, prev_means = [], {}
    if out_path.exists():
        try:
            prev = json.loads(out_path.read_text())
            prev_rows = [r for r in prev.get("rows", []) if r.get("tower") not in rescored]
            prev_means = {t: m for t, m in prev.get("mean_by_tower", {}).items() if t not in rescored}
        except (json.JSONDecodeError, OSError) as e:
            log(f"could not merge existing {args.out}: {e}")
    all_rows = prev_rows + all_rows

    # per-tower means and a markdown table
    all_names = SCORE_NAMES + CAL_NAMES
    out = {"rows": all_rows, "knn_k": args.knn_k, "mean_by_tower": prev_means}
    lines = ["| tower | " + " | ".join(f"AUROC {n}" for n in all_names) + " |", "|---|" + "---|" * len(all_names)]
    for tower in towers:
        rows = [r for r in all_rows if r["tower"] == tower]
        if not rows:
            continue
        means = {n: round(float(np.mean([r[f"auroc_{n}"] for r in rows])), 3) for n in all_names}
        out["mean_by_tower"][tower] = means
        lines.append(f"| {tower} | " + " | ".join(str(means[n]) for n in all_names) + " |")
    print("\n".join(lines))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2) + "\n")
    log(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
