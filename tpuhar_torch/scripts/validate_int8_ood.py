"""int8 OOD-AUROC parity on trained leave-one-out fusion checkpoints: f32 against int8
towers (``scripts/validate_int8_ood.py``).

The north star is throughput at OOD-AUROC parity (``BASELINE.md``). For each
leave-one-activity-out checkpoint that ``bench_accuracy`` writes
(``<root>/<tower>/checkpoints/ood_loo_{c}``) this scores the ID and OOD test windows
through

- the f32 path: ``FusionClassifier`` on normalized clips (the Evaluator's semantics);
- the int8 path: the tower quantized from the same checkpoint (``serving_quant.
  build_quantized_tree``: calibrated on id-train clips, ``input_fold`` for ``tpu_cnn``
  and the ViTs) and ``fuse_with_tokens``, the quantized serving program's semantics;
  ``int8res`` its int8-resident form, and for ``tpu_cnn`` ``int8pm``, the resident
  tower on the shipped uint8 patch-major wire (the host's shuffle);
- ``<path>r``: each int8 path with the serving program's affine logit recalibration,
  fitted on id-train logits;

fits Mahalanobis per path on that path's own id-train embeddings and reports MSP, energy
and Mahalanobis AUROC and FPR@95 side by side, the ID accuracy, and the transfer of
f32-fitted OOD thresholds to the recalibrated int8 path. The JSON is the JAX script's.

The port's int8 ``tpu_cnn`` stem reads only the patch-major wire on the card, so the
NHWC paths (``int8``, ``int8res``) shuffle the clip on the device
(``ops/stem.to_patch_major_tensor``) where the JAX package's run its conv lowering;
``int8pm`` ships the host's shuffle, and its logits must equal ``int8res``'s (the run
exits 2 otherwise).

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.validate_int8_ood [--classes 0,2,4] [--tower tpu_cnn] [--cpu]``
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ._common import find_checkpoint, fusion_model, log, restore_fusion_variables, score_split, script_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--classes", default="0,2,4")
    p.add_argument("--tower", default="tpu_cnn")
    p.add_argument("--root", default="outputs/torch/bench_accuracy")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument(
        "--no-resident", action="store_true",
        help="skip the int8-resident serving path (ops/quant "
        "quant_tpucnn_forward_resident; scored as int8res/int8resr by default)",
    )
    p.add_argument(
        "--checkpoint", default="",
        help="checkpoint name under ood_loo_{c}/ (default: 'last' then "
        "'best_model' — matching the state the head-to-head evaluator scored)",
    )
    p.add_argument("--out", default="outputs/torch/bench_accuracy/int8_ood_parity.json")
    p.add_argument(
        "--allow-data-mismatch", action="store_true",
        help="skip the checkpoint↔data fingerprint check (parity deltas stay "
        "path-vs-path valid, but absolute scores are meaningless when the "
        "data was regenerated since training)",
    )
    return p.parse_args(argv)


def load_config(root: Path, tower: str, batch: int):
    """The training-time config ``bench_accuracy`` recorded beside the checkpoints, or
    for checkpoints without one its construction by convention."""
    from ..config import Config
    from ..data.synthetic import make_synthetic_config

    saved = root / tower / "checkpoints" / "config.json"
    if saved.exists():
        cfg = Config.load(saved)
    else:
        cfg = make_synthetic_config(
            root / "fixture", root / tower, num_classes=6, video_backbone=tower,
            video_resize=(224, 224), train_epochs=4, train_batch_size=batch,
        )
        cfg.data.video_frames_per_window = 16
    cfg.data.featurize_backend = "host"
    cfg.paths.preprocessed_dir = root / "preprocessed"
    return cfg


def int8_paths(model, variables, q, device, *, resident: bool):
    """The int8 programs over the quantized tree ``q`` and ``model`` (``fusion_model`` of
    ``variables``): ``{name: fn(imu, video_u8) -> (logits, embeddings)}`` for ``int8``
    and, with ``resident`` and a CNN tower, ``int8res`` (and ``int8pm`` for ``tpu_cnn``)."""
    from ..ops.quant import (
        quant_resnet18_forward,
        quant_resnet18_forward_resident,
        quant_tpucnn_forward,
        quant_tpucnn_forward_resident,
    )
    from ..ops.quant_vit import quant_vit_forward
    from ..ops.stem import to_patch_major, to_patch_major_tensor
    from ..ops.video import clip_stats, normalize_clip
    from ..serving_quant import _tower_kind

    proj = variables["params"]["video_encoder"]["projection"]
    proj_kernel = torch.tensor(np.asarray(proj["kernel"], np.float32), device=device)
    proj_bias = torch.tensor(np.asarray(proj["bias"], np.float32), device=device)
    dtype = model.video_to_fusion.weight.dtype
    kind = _tower_kind(q)
    mean, std = clip_stats(device)

    def path(tower, patch_major: bool = False):
        def fn(imu, video_u8):
            B, T = video_u8.shape[:2]
            if kind == "vit":
                feats = tower(q, video_u8)  # whole clips, raw uint8 (folded stem)
            else:
                if kind == "tpu_cnn":
                    frames = video_u8 if patch_major else to_patch_major_tensor(video_u8, q["patch"])
                else:
                    frames = normalize_clip(video_u8, mean=mean, std=std)
                feats = tower(q, frames.reshape(B * T, *frames.shape[2:])).reshape(B, T, -1)
            tokens = feats @ proj_kernel + proj_bias
            return model.fuse_with_tokens(imu, tokens.to(dtype))

        if not patch_major:
            return fn
        # the shipped engine layout: the host's patch-major shuffle, the stem one GEMM
        return lambda imu, video_u8: fn(
            imu, torch.from_numpy(to_patch_major(video_u8.cpu().numpy(), q["patch"])).to(device)
        )

    if kind == "vit":
        return {"int8": path(quant_vit_forward)}
    base, res = (
        (quant_resnet18_forward, quant_resnet18_forward_resident) if kind == "resnet18"
        else (quant_tpucnn_forward, quant_tpucnn_forward_resident)
    )
    paths = {"int8": path(base)}
    if resident:
        paths["int8res"] = path(res)
        if kind == "tpu_cnn":
            paths["int8pm"] = path(res, patch_major=True)
    return paths


def score_class(args, cfg, dfs, c: int, device):
    """One held-out class: ``(row, split_scores)``, ``split_scores[name]`` the path's
    ``(train logits, train embeddings, id logits, id embeddings, ood logits, ood
    embeddings)``; ``None`` where the class has no checkpoint."""
    from ..data.loader import BatchLoader
    from ..eval.metrics import auroc
    from ..ood import MahalanobisScorer, compute_ood_scores, fit_ood_thresholds, fpr_at_tpr, leave_one_out_split
    from ..ops.video import normalize_clip
    from ..serving_quant import build_quantized_tree, fit_logit_recalibration

    # score the state the head-to-head evaluator scored: the trainer's fit returns
    # the last epoch's state, and OODEvaluator's reuse prefers "last"
    ckpt_dir = Path(args.root) / args.tower / "checkpoints" / f"ood_loo_{c}"
    ckpt_path = find_checkpoint(ckpt_dir, (args.checkpoint,) if args.checkpoint else ("last", "best_model"))
    if ckpt_path is None:
        log(f"missing checkpoint under {ckpt_dir} — skipping class {c}")
        return None
    id_train, _, remap = leave_one_out_split(dfs["train"], c)
    id_test, ood_test, _ = leave_one_out_split(dfs["test"], c, remap=remap)
    loo_cfg = copy.deepcopy(cfg)
    loo_cfg.model.num_classes = len(remap)
    variables = restore_fusion_variables(loo_cfg, ckpt_path)
    log(f"[class {c}] scoring checkpoint {ckpt_path.name}")

    # the int8 tower of the same checkpoint, calibrated on id-train clips
    calib_loader = BatchLoader(id_train.head(args.batch), loo_cfg, mode="fusion", batch_size=min(8, args.batch), prefetch=0)
    calib_u8 = next(iter(calib_loader))["video"]
    q = build_quantized_tree(variables, calib_u8, device=device)
    model = fusion_model(loo_cfg, variables, device)

    def f32_path(imu, video_u8):
        return model(imu, normalize_clip(video_u8))

    is_vit = "depth" in q
    paths = {"f32": f32_path, **int8_paths(model, variables, q, device, resident=not args.no_resident and not is_vit)}
    row = {"held_out_class": c}
    split_scores = {}
    for name, fn in paths.items():
        split_scores[name] = (
            *score_split(id_train, loo_cfg, fn, args.batch, device),
            *score_split(id_test, loo_cfg, fn, args.batch, device),
            *score_split(ood_test, loo_cfg, fn, args.batch, device),
        )
    if "int8pm" in split_scores:
        # layout exactness on the scoring device: the host's patch-major wire must
        # give the device shuffle's logits (the same int8 values into the same GEMM)
        d = max(float(np.abs(a - b).max()) for a, b in zip(split_scores["int8res"][:6:2], split_scores["int8pm"][:6:2]))
        row["pm_logit_maxdelta"] = d
        log(f"[class {c}] patch-major vs NHWC resident logit maxdelta: {d:.3e}")

    # int8r / int8resr: the shipped serving semantics, the affine logit map fitted on
    # the calibration split (id-train) applied to held-out logits; embeddings untouched
    for name in [n for n in paths if n != "f32"]:
        a, b = fit_logit_recalibration(split_scores["f32"][0], split_scores[name][0])
        tr_lg, tr_em, id_lg, id_em, ood_lg, ood_em = split_scores[name]
        split_scores[f"{name}r"] = (a * tr_lg + b, tr_em, a * id_lg + b, id_em, a * ood_lg + b, ood_em)

    et = cfg.ood.energy_temperature
    tr_labels = np.asarray(id_train["label"], np.int32)  # leave_one_out_split remapped them
    path_scores = {}
    for name, (tr_lg, tr_em, id_lg, id_em, ood_lg, ood_em) in split_scores.items():
        maha = MahalanobisScorer.fit(tr_em, tr_labels, len(remap))
        tr_s, id_s, ood_s = (
            compute_ood_scores(lg, em, mahalanobis=maha, energy_temperature=et)
            for lg, em in ((tr_lg, tr_em), (id_lg, id_em), (ood_lg, ood_em))
        )
        path_scores[name] = (tr_s, id_s, ood_s)
        for s in id_s:
            joined = np.concatenate([id_s[s], ood_s[s]])
            is_ood = np.concatenate([np.zeros(len(id_s[s])), np.ones(len(ood_s[s]))])
            row[f"{name}_auroc_{s}"] = round(float(auroc(joined, is_ood)), 4)
            row[f"{name}_fpr95_{s}"] = round(float(fpr_at_tpr(joined, is_ood)), 4)
        row[f"{name}_id_acc"] = round(float((np.argmax(id_lg, 1) == np.asarray(id_test["label"])).mean() * 100), 2)

    # threshold transfer: the 95% ID-quantile threshold of each score fitted on the f32
    # path's id-train scores, applied to both paths' held-out scores; beside it the
    # int8r path's own refit
    thr = fit_ood_thresholds(path_scores["f32"][0], id_fpr=0.05)
    for s, t in thr.items():
        entry = {}
        for name in ("f32", "int8r"):
            _, id_s, ood_s = path_scores[name]
            entry[f"{name}_id_fpr"] = round(float((id_s[s] >= t).mean()), 4)
            entry[f"{name}_ood_tpr"] = round(float((ood_s[s] >= t).mean()), 4)
        t8 = fit_ood_thresholds({s: path_scores["int8r"][0][s]}, id_fpr=0.05)[s]
        _, id8, ood8 = path_scores["int8r"]
        entry["int8r_refit_id_fpr"] = round(float((id8[s] >= t8).mean()), 4)
        entry["int8r_refit_ood_tpr"] = round(float((ood8[s] >= t8).mean()), 4)
        row[f"thrx_{s}"] = entry
    return row, split_scores


def run(args):
    """Every class of ``args.classes``: ``(rows, {class: split_scores})``; the rows are
    written to ``args.out`` after each class."""
    import pandas as pd

    from ..data.preprocess import FINGERPRINT_FILENAME, verify_data_fingerprint
    from ..ops.stem import verify_byte_map

    device = script_device(args.cpu)
    log(f"device: {device}")
    # fail in seconds, not after minutes of scoring, if the stem's byte map is wrong here
    verify_byte_map(device)
    log("byte-map preflight: exact on this device")

    root = Path(args.root)
    cfg = load_config(root, args.tower, args.batch)
    # refuse to score checkpoints against data they were not trained on
    if not args.allow_data_mismatch:
        verify_data_fingerprint(
            root / args.tower / "checkpoints" / FINGERPRINT_FILENAME, root / "preprocessed",
            context=f"{args.tower} checkpoints",
        )
    dfs = {split: pd.read_csv(root / "preprocessed" / f"{split}_metadata.csv") for split in ("train", "val", "test")}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    results, scores = [], {}
    for c in [int(x) for x in args.classes.split(",")]:
        t0 = time.perf_counter()
        scored = score_class(args, cfg, dfs, c, device)
        if scored is None:
            continue
        row, scores[c] = scored
        results.append(row)
        log(f"[class {c}] ({time.perf_counter() - t0:.0f}s) " + json.dumps(row))
        out.write_text(json.dumps(results, indent=2))
    return results, scores


def main(argv=None):
    args = parse_args(argv)
    results, _ = run(args)
    # summary deltas (int8: the raw quantized logits; int8r: the shipped recalibrated
    # path; int8res/int8resr: the int8-resident form, raw and recalibrated)
    names = ["int8", "int8r"]
    if results and "int8res_auroc_msp" in results[0]:
        names += ["int8res", "int8resr"]
    for name in names:
        for s in ("msp", "energy", "mahalanobis"):
            d = [r[f"{name}_auroc_{s}"] - r[f"f32_auroc_{s}"] for r in results]
            log(f"AUROC delta {name}-f32 [{s}]: mean {np.mean(d):+.4f} max |{np.max(np.abs(d)):.4f}|")
    # the patch-major wire must be logit-exact against the device shuffle (the same
    # int8 values through the same epilogue): fail loudly rather than ship the rows
    pm = [r["pm_logit_maxdelta"] for r in results if "pm_logit_maxdelta" in r]
    if pm and max(pm) > 1e-3:
        log(
            f"FATAL: the patch-major stem is NOT exact on this device (logit maxdelta {max(pm):.3e} > 1e-3): "
            "the int8pm rows score a wrong program (tpuhar_torch/ops/stem.py)."
        )
        sys.exit(2)
    return results


if __name__ == "__main__":
    main()
