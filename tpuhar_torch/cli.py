"""The pipeline and its command line (``tpuhar/cli.py``): preprocess → pretrain →
zero-shot → classify → evaluate → ood → report, and serve, on one device.

    python -m tpuhar_torch --mode all --config cfg.json [--set section.key=value ...]
    python -m tpuhar_torch --mode serve --serve-batch 64
    python -m tpuhar_torch --device cpu ...   # the plain paths, no card

``Pipeline(config, device="cuda")`` runs every stage on ``device``: ``"cuda"`` (the
default) raises without a card, ``"cpu"`` runs the kernels' plain versions. The stages
and their artifacts keep the JAX package's names, places and column schemas
(``results/pretraining_curves.png``, ``classification_comparison.csv`` with the ``cal_*``
columns, ``confusion_{mode}.png``, ``test_logits_{mode}.npy``,
``fewshot_results_{raw,agg}.csv``, ``fewshot_table3.csv``, ``zeroshot_results.json``,
``ood_results{,_agg}.csv``, ``serving_predictions_{split}.csv``, ``final_report.json`` and
the article tables); the checkpoints are the port's ``.pt``/``.json`` pairs
(``train/checkpoint``). ``run_all`` skips preprocessing when its metadata exists and
pretraining when its best checkpoint does.

Randomness: ``set_seed(training.seed)`` gives the root CPU generator; each use draws a
seed from it (``train.factory.split_seeds``), where the JAX package splits its key, and
fresh parameters come from ``bridge.init_params`` with that generator.

Every plot goes through ``Pipeline._plot``: where matplotlib is missing (the card's
machine has none) it prints ``[Report] matplotlib is not installed: <path> not written``
and the stage goes on; the JAX package's CLI does not start without matplotlib. Not
ported: the training mesh (ROADMAP queue 1 item 8e): one device trains and serves.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .bridge import init_params, variables_to_numpy
from .config import CONFIG, Config
from .data.loader import create_dataloaders
from .data.preprocess import Preprocessor
from .eval.evaluator import Evaluator, FewShotEvaluator, save_results_table
from .models.crossmodal import CrossModalModel, IMUClassifier
from .ood import OODEvaluator
from .report import plots
from .report.tables import create_article_tables_from_results
from .train import checkpoint as ckpt
from .train.factory import build_classification_task, build_crossmodal_task, split_seeds
from .train.loop import ClassificationTrainer, CrossModalTrainer
from .train.steps import precision_scope
from .utils import check_dataset_paths, describe_devices, resolve_device, set_seed


class Pipeline:
    """The stages over the port on one device (``tpuhar/cli.py: Pipeline``)."""

    def __init__(self, config: Optional[Config] = None, *, device="cuda"):
        self.config = config or CONFIG
        self.device = resolve_device(device, "Pipeline")
        self.config.paths.ensure_dirs()
        self.root_key = set_seed(self.config.training.seed)
        self.serving_stats: Dict = {}  # run_serving's windows, batches, seconds and graph launches
        print(f"[Pipeline] devices: {describe_devices()}; running on {self.device}")
        status = check_dataset_paths(self.config)
        if not status["ok"]:
            print(f"[Pipeline] dataset path check: {status}")

    # -- helpers --------------------------------------------------------------------
    def _metadata(self, split: str):
        import pandas as pd

        path = Path(self.config.paths.preprocessed_dir) / f"{split}_metadata.csv"
        if not path.exists():
            raise FileNotFoundError(f"Missing {path}; run `--mode preprocess` first.")
        return pd.read_csv(path)

    def _next_key(self, device="cpu") -> torch.Generator:
        """A generator on ``device`` seeded from the root generator (the JAX package's
        ``split`` of its root key)."""
        return torch.Generator(device=device).manual_seed(split_seeds(self.root_key, 1)[0])

    @staticmethod
    def _plot(fn, *args, save_path, **kwargs) -> bool:
        """``fn(*args, save_path=save_path, **kwargs)``; where matplotlib does not import,
        say which plot was not written and go on. Returns whether it was written."""
        try:
            fn(*args, save_path=save_path, **kwargs)
        except ImportError as e:
            if not (e.name or "").startswith("matplotlib"):
                raise
            print(f"[Report] matplotlib is not installed: {save_path} not written")
            return False
        return True

    def _crossmodal_task(self, steps_per_epoch: int):
        params = init_params(self.config, self._next_key(), CrossModalModel)
        return build_crossmodal_task(self.config, steps_per_epoch, params, device=self.device)

    def _load_pretrained_encoder(self):
        """The best cross-modal checkpoint's IMU encoder subtree ``(params, batch_stats)``
        (flax layout, numpy), or ``(None, None)`` without one."""
        best = Path(self.config.paths.checkpoints_dir) / "cross_modal" / "best_model"
        if not ckpt.checkpoint_exists(best):
            return None, None
        task = self._crossmodal_task(1)
        ckpt.restore_checkpoint(best, task.state, model_only=True)
        tree = variables_to_numpy(task.model)
        return tree["params"]["imu_encoder"], tree["batch_stats"].get("imu_encoder")

    # -- stages ---------------------------------------------------------------------
    def run_preprocessing(self) -> Dict:
        print("\n=== Stage: preprocessing ===")
        return Preprocessor(self.config, device=self.device).run_full_preprocessing()

    def run_pretraining(self, resume: bool = False):
        print("\n=== Stage: cross-modal pretraining ===")
        cfg = self.config
        train_df, val_df, test_df = self._metadata("train"), self._metadata("val"), self._metadata("test")
        loaders = create_dataloaders(cfg, train_df, val_df, test_df, mode="cross_modal", device=self.device)
        spe = max(len(loaders["train"]), 1)
        # the f32 operands' matmul precision (default full f32); bf16 towers are untouched
        with precision_scope(str(getattr(cfg.training, "pretrain_matmul_precision", "float32"))):
            task = self._crossmodal_task(spe)
            trainer = CrossModalTrainer(
                cfg, task.state, task.train_step, task.eval_step,
                Path(cfg.paths.checkpoints_dir) / "cross_modal", self._next_key(self.device),
            )
            task.state = trainer.fit(loaders["train"], loaders["val"], resume=resume)
        self._plot(plots.plot_training_curves, trainer.history,
                   save_path=Path(cfg.paths.results_dir) / "pretraining_curves.png", title="Cross-modal pretraining")
        print(f"[Pretrain] best val loss: {trainer.best_metric:.4f}")
        ckpt.save_params(Path(cfg.paths.checkpoints_dir) / "final_model_params", task.model)
        return trainer

    def run_classification(self, classify_mode: str = "both", resume: bool = False):
        print("\n=== Stage: IMU classification ===")
        import pandas as pd

        from .eval.calibration import apply_temperature, expected_calibration_error, fit_temperature

        cfg = self.config
        train_df, val_df, test_df = self._metadata("train"), self._metadata("val"), self._metadata("test")
        enc_params, enc_bs = self._load_pretrained_encoder()
        if enc_params is None:
            print("[Classify] no pretrained encoder found — training from scratch")
        results_dir = Path(cfg.paths.results_dir)
        modes = ["linear_probe", "finetune"] if classify_mode == "both" else [classify_mode]
        comparison = {}
        for mode in modes:
            print(f"\n--- {mode} ---")
            loaders = create_dataloaders(cfg, train_df, val_df, test_df, mode="classification", device=self.device)
            spe = max(len(loaders["train"]), 1)
            task = build_classification_task(
                cfg, mode, spe, init_params(cfg, self._next_key(), IMUClassifier),
                encoder_params=enc_params, encoder_batch_stats=enc_bs, device=self.device,
            )
            trainer = ClassificationTrainer(
                cfg, task.state, task.train_step, task.eval_step,
                Path(cfg.paths.checkpoints_dir) / f"classifier_{mode}", self._next_key(self.device), mode,
            )
            task.state = trainer.fit(loaders["train"], loaders["val"], resume=resume)
            best = trainer.save_dir / "best_model"
            if ckpt.checkpoint_exists(best):
                task.state, _ = ckpt.restore_checkpoint(best, task.state)
            evaluator = Evaluator(task, cfg)
            result = evaluator.evaluate(loaders["test"])
            # the temperature is fitted on the validation split, never on test; the
            # fitted T is what a deployment passes to InferenceEngine(temperature=)
            _, val_labels, val_logits, _ = evaluator.predict(loaders["val"])
            temp = fit_temperature(val_logits, val_labels)
            scaled = expected_calibration_error(
                apply_temperature(result["logits"], temp).cpu().numpy(), result["labels"]
            )
            comparison[mode] = {
                **result["metrics"],
                **{f"cal_{k}": v for k, v in result["calibration"].items()},
                "cal_temperature": temp,
                "cal_ece_scaled": scaled["ece"],
            }
            print(f"[Classify:{mode}] test bal_acc={result['metrics']['balanced_accuracy']:.2f}")
            self._plot(plots.plot_confusion_matrix, result["labels"], result["predictions"], cfg.model.num_classes,
                       save_path=results_dir / f"confusion_{mode}.png")
            np.save(results_dir / f"test_logits_{mode}.npy", result["logits"])
        df = pd.DataFrame(comparison).T
        df.to_csv(results_dir / "classification_comparison.csv")
        print(f"\n{df}")
        return df

    def run_evaluation(self):
        print("\n=== Stage: few-shot evaluation ===")
        cfg = self.config
        train_df, test_df = self._metadata("train"), self._metadata("test")
        try:
            val_df = self._metadata("val")
        except FileNotFoundError:
            val_df = None
        enc_params, _ = self._load_pretrained_encoder()
        if enc_params is None:
            print("[FewShot] no pretrained encoder — using random init")
        evaluator = FewShotEvaluator(cfg, self._next_key(), device=self.device)
        if cfg.eval.parallel_few_shot:
            from .eval.fewshot_parallel import run_parallel_fewshot

            raw = run_parallel_fewshot(cfg, enc_params, train_df, test_df, val_df, experiment_name="cross_modal",
                                       generator=self._next_key(), device=self.device)
        else:
            raw = evaluator.run_few_shot_experiments(enc_params, train_df, test_df, val_df,
                                                     experiment_name="cross_modal")
        agg = evaluator.aggregate_results(raw)
        results_dir = Path(cfg.paths.results_dir)
        raw.to_csv(results_dir / "fewshot_results_raw.csv", index=False)
        agg.to_csv(results_dir / "fewshot_results_agg.csv", index=False)
        table = evaluator.create_comparison_table({"cross_modal": raw})
        save_results_table(table, results_dir / "fewshot_table3.csv")
        print(f"\n{table}")
        return raw

    def run_zeroshot(self) -> Dict:
        """Zero-shot IMU classification by video class prototypes →
        ``zeroshot_results.json``."""
        print("\n=== Stage: zero-shot evaluation ===")
        import pandas as pd

        from .eval.zeroshot import run_zero_shot

        cfg = self.config
        train_df, test_df = self._metadata("train"), self._metadata("test")
        best = Path(cfg.paths.checkpoints_dir) / "cross_modal" / "best_model"
        if not ckpt.checkpoint_exists(best):
            raise FileNotFoundError("Zero-shot needs a pretrained cross-modal checkpoint")
        task = self._crossmodal_task(1)
        task.state, _ = ckpt.restore_checkpoint(best, task.state)
        results = run_zero_shot(task, train_df, test_df, cfg,
                                save_path=Path(cfg.paths.results_dir) / "zeroshot_results.json")
        print(pd.DataFrame(results).T)
        return results

    def run_ablations(self):
        """The encoder and featurizer ablation grid → ``ablation_results.csv``."""
        print("\n=== Stage: ablations ===")
        from .eval.ablation import run_ablations

        cfg = self.config
        train_df, val_df, test_df = self._metadata("train"), self._metadata("val"), self._metadata("test")
        df = run_ablations(cfg, train_df, val_df, test_df, generator=self._next_key(), device=self.device)
        df.to_csv(Path(cfg.paths.results_dir) / "ablation_results.csv", index=False)
        print(f"\n{df}")
        return df

    def run_ood(self, resume: bool = False):
        """Leave-one-activity-out OOD scoring; ``resume`` reuses finished ``ood_loo_{c}``
        checkpoints, so an interrupted sweep trains only its missing classes."""
        print("\n=== Stage: OOD leave-one-activity-out ===")
        cfg = self.config
        train_df, val_df, test_df = self._metadata("train"), self._metadata("val"), self._metadata("test")
        enc_params, _ = self._load_pretrained_encoder()
        results = OODEvaluator(cfg, self._next_key(), device=self.device).run_loo_experiments(
            train_df, val_df, test_df, encoder_params=enc_params,
            model_kind=str(getattr(cfg.ood, "model_kind", "imu")), reuse_checkpoints=resume,
        )
        results_dir = Path(cfg.paths.results_dir)
        results.to_csv(results_dir / "ood_results.csv", index=False)
        if len(results):
            agg = OODEvaluator.aggregate(results)
            agg.to_csv(results_dir / "ood_results_agg.csv")
            print(f"\n{agg}")
        return results

    def run_serving(
        self,
        split: str = "test",
        checkpoint: Optional[str] = None,
        imu_only: bool = True,
        int8: bool = False,
        batch_size: int = 64,
        ood_id_fpr: Optional[float] = None,
    ):
        """Serve the raw split through ``InferenceEngine.predict_stream`` and write
        ``serving_predictions_{split}.csv`` (label, pred, msp, energy, and ``is_ood_*``
        with ``ood_id_fpr``). The default checkpoint is the pipeline's
        ``classifier_finetune`` (IMU-only); ``checkpoint`` with ``imu_only=False`` serves
        a fusion classifier on decoded clips, ``int8`` its int8 tower calibrated on the
        split's first 8 windows. ``ood_id_fpr`` fits the decision thresholds on the val
        split's traffic through this engine."""
        print("\n=== Stage: serving ===")
        import pandas as pd

        from .data.raw_stream import raw_serving_stream
        from .serving import InferenceEngine

        cfg = self.config
        df = self._metadata(split)
        if checkpoint is None:
            checkpoint = str(Path(cfg.paths.checkpoints_dir) / "classifier_finetune" / "best_model")
            imu_only = True
        if not ckpt.checkpoint_exists(Path(checkpoint)):
            raise FileNotFoundError(
                f"No checkpoint at {checkpoint}; run `--mode classify` first or pass --serve-checkpoint"
            )
        kw = {}
        if int8:
            if imu_only:
                raise ValueError("--serve-int8 applies to fusion (video) serving")
            calib = next(raw_serving_stream(cfg, df, batch_size=8, with_video=True))
            kw["quantize_calib_clips"] = calib[1]
            kw["quantize_calib_imu"] = calib[0]
        engine = InferenceEngine.from_checkpoint(cfg, checkpoint, imu_only=imu_only, batch_sizes=[batch_size],
                                                 device=self.device, **kw)
        if ood_id_fpr is not None:
            val_df = self._metadata("val").head(8 * batch_size)
            calib_imu, calib_video = [], []
            for batch in raw_serving_stream(cfg, val_df, batch_size=batch_size, with_video=not imu_only):
                calib_imu.append(batch[0])
                if not imu_only:
                    calib_video.append(batch[1])
            thresholds = engine.calibrate_ood_thresholds(
                np.concatenate(calib_imu), np.concatenate(calib_video) if calib_video else None,
                id_fpr=float(ood_id_fpr),
            )
            print(f"[Serve] OOD thresholds @ id_fpr={ood_id_fpr}: "
                  + ", ".join(f"{k}={v:.4f}" for k, v in thresholds.items()))
        stream = raw_serving_stream(cfg, df, batch_size=batch_size, with_video=not imu_only)
        rows, served, batches = [], 0, 0
        t0 = time.perf_counter()
        for out in engine.predict_stream(stream):
            n = len(out["preds"])
            batches += 1
            for j in range(n):
                row = {"pred": int(out["preds"][j]), "msp": float(out["msp"][j]), "energy": float(out["energy"][j])}
                for k in out:  # the decision flags, once thresholds are set
                    if k.startswith("is_ood_"):
                        row[k] = bool(out[k][j])
                rows.append(row)
            served += n
        wall = time.perf_counter() - t0
        result = df.reset_index(drop=True).loc[: served - 1, ["label"]].copy()
        pred_df = pd.DataFrame(rows)
        result[pred_df.columns] = pred_df
        out_path = Path(cfg.paths.results_dir) / f"serving_predictions_{split}.csv"
        result.to_csv(out_path, index=False)
        acc = float((result["pred"] == result["label"]).mean()) * 100
        self.serving_stats = {"windows": served, "batches": batches, "seconds": wall,
                              "graph_launches": dict(engine.graph_launches.get(batch_size, {}))}
        print(f"[Serve] {served} windows in {wall:.1f}s = {served / wall:.1f} inf/s "
              f"(accuracy {acc:.2f}%) -> {out_path}")
        return result

    def run_all(self, classify_mode: str = "both", resume: bool = False):
        """Every stage, skipping preprocessing and pretraining where their artifacts
        exist; a zero-shot failure is printed and skipped."""
        cfg = self.config
        t0 = time.time()
        if not (Path(cfg.paths.preprocessed_dir) / "train_metadata.csv").exists():
            self.run_preprocessing()
        else:
            print("[run_all] preprocessing artifacts found — skipping")
        if not ckpt.checkpoint_exists(Path(cfg.paths.checkpoints_dir) / "cross_modal" / "best_model"):
            self.run_pretraining(resume=resume)
        else:
            print("[run_all] pretraining checkpoint found — skipping")
        try:
            self.run_zeroshot()
        except Exception as e:
            print(f"[run_all] zero-shot skipped: {e}")
        self.run_classification(classify_mode, resume=resume)
        self.run_evaluation()
        if cfg.ood.enabled:
            self.run_ood(resume=resume)
        self.generate_final_report()
        print(f"[run_all] total {time.time() - t0:.0f}s")

    def generate_final_report(self) -> Dict:
        """``final_report.json`` from the stages' artifacts, then the article tables."""
        import pandas as pd

        cfg = self.config
        results_dir = Path(cfg.paths.results_dir)
        report: Dict = {"config": cfg.to_dict(), "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}
        try:
            comp = results_dir / "classification_comparison.csv"
            if comp.exists():
                report["classification"] = pd.read_csv(comp, index_col=0).to_dict(orient="index")
        except Exception as e:
            report["classification_error"] = str(e)
        try:
            agg = results_dir / "fewshot_results_agg.csv"
            if agg.exists():
                report["few_shot"] = pd.read_csv(agg).to_dict(orient="records")
        except Exception as e:
            report["few_shot_error"] = str(e)
        try:
            oodp = results_dir / "ood_results_agg.csv"
            if oodp.exists():
                report["ood"] = pd.read_csv(oodp).to_dict(orient="records")
        except Exception as e:
            report["ood_error"] = str(e)
        try:
            hist = Path(cfg.paths.checkpoints_dir) / "cross_modal" / "training_history.json"
            if hist.exists():
                report["pretraining_history"] = json.loads(hist.read_text())
        except Exception as e:
            report["pretraining_error"] = str(e)
        out = results_dir / "final_report.json"
        out.write_text(json.dumps(report, indent=2, default=str))
        print(f"[Report] {out}")
        create_article_tables_from_results(results_dir)
        return report


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m tpuhar_torch",
        description="Cross-modal IMU-video HAR pipeline on PyTorch (one CUDA device, or the CPU with --device "
        "cpu). Training over a mesh of devices is not ported (ROADMAP queue 1 item 8e).",
    )
    parser.add_argument(
        "--mode",
        choices=["preprocess", "pretrain", "classify", "evaluate", "zeroshot", "ood", "ablate", "report", "serve",
                 "all"],
        default="all",
    )
    parser.add_argument("--device", default="cuda",
                        help="where every stage runs: 'cuda' (default; fails without a card) or 'cpu'")
    parser.add_argument("--serve-split", default="test")
    parser.add_argument(
        "--serve-checkpoint", default=None,
        help="checkpoint to serve (default: the pipeline's classifier_finetune, IMU-only); fusion checkpoints "
        "imply video decoding",
    )
    parser.add_argument("--serve-fusion", action="store_true",
                        help="the --serve-checkpoint is a FusionClassifier (IMU+video serving)")
    parser.add_argument("--serve-int8", action="store_true",
                        help="serve the fusion tower through the int8 PTQ program")
    parser.add_argument("--serve-batch", type=int, default=64)
    parser.add_argument(
        "--serve-ood-fpr", type=float, default=None,
        help="calibrate per-score OOD decision thresholds on the val split at this target ID false-positive rate "
        "(e.g. 0.05); adds is_ood_* columns to the serving CSV",
    )
    parser.add_argument("--classify-mode", choices=["linear_probe", "finetune", "both"], default="both")
    parser.add_argument("--config", type=str, default=None, help="JSON config to load")
    parser.add_argument("--resume", action="store_true", help="resume interrupted training from last")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="config override, e.g. --set training.pretrain_epochs=3")
    return parser


def main(argv=None) -> Pipeline:
    """Parse ``argv``, run the chosen mode; returns the pipeline (``serving_stats`` after
    ``--mode serve``)."""
    args = build_parser().parse_args(argv)
    config = Config.load(args.config) if args.config else CONFIG
    for override in args.set:
        key, value = override.split("=", 1)
        config.override(key, value)

    pipeline = Pipeline(config, device=args.device)
    if args.mode == "preprocess":
        pipeline.run_preprocessing()
    elif args.mode == "pretrain":
        pipeline.run_pretraining(resume=args.resume)
    elif args.mode == "classify":
        pipeline.run_classification(args.classify_mode, resume=args.resume)
    elif args.mode == "evaluate":
        pipeline.run_evaluation()
    elif args.mode == "zeroshot":
        pipeline.run_zeroshot()
    elif args.mode == "ablate":
        pipeline.run_ablations()
    elif args.mode == "ood":
        pipeline.run_ood(resume=args.resume)
    elif args.mode == "report":
        pipeline.generate_final_report()
    elif args.mode == "serve":
        pipeline.run_serving(
            split=args.serve_split, checkpoint=args.serve_checkpoint, imu_only=not args.serve_fusion,
            int8=args.serve_int8, batch_size=args.serve_batch, ood_id_fpr=args.serve_ood_fpr,
        )
    else:
        pipeline.run_all(args.classify_mode, resume=args.resume)
    return pipeline


if __name__ == "__main__":
    main()
