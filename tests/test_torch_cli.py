"""The port's pipeline and command line (``tpuhar_torch/cli.py``) on the CPU: the
contracts of ``tests/test_pipeline.py`` at its ``_shrink`` sizes, with
``Pipeline(device="cpu")``.

- A pass through every stage, each stage's artifacts checked; ``final_report.json``
  (less its timestamp) and the article tables equal to what the JAX package's
  ``Pipeline.generate_final_report`` writes from the same results directory; serving
  through ``main(["--mode", "serve", ...])`` writes the JAX package's columns.
- ``run_all`` skips preprocessing and pretraining whose artifacts exist.
- ``--config`` (a config saved by either package) and ``--set`` round trips;
  ``--device cuda`` without a card raises.

The conftest's synthetic dataset is preprocessed once for the module by the port's
pipeline; each test copies the preprocessed directory into an output root of its own.
"""
import copy
import json
import shutil
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from tpuhar_torch.cli import Pipeline, build_parser, main
from tpuhar_torch.config import Config
from tpuhar_torch.data.synthetic import make_synthetic_config
from tpuhar_torch.train import checkpoint as ckpt

torch.set_num_threads(2)


def shrink(cfg):
    """``tests/test_pipeline.py``'s ``_shrink``."""
    m = cfg.model
    m.imu_num_layers, m.imu_d_model, m.imu_nhead = 1, 32, 4
    m.classifier_hidden_dims, m.compute_dtype, m.head_norm = [16], "float32", "layer"
    m.video_d_model, m.projection_dim, m.projection_hidden_dim = 48, 16, 32
    cfg.data.video_frames_per_window = 4
    t = cfg.training
    t.pretrain_epochs, t.train_epochs, t.pretrain_batch_size, t.train_batch_size = 2, 2, 4, 8
    cfg.eval.few_shot_samples, cfg.eval.few_shot_runs = [2], 1
    cfg.ood.leave_out_classes = [0]
    return cfg


def preprocessed(synthetic_dataset, root: Path) -> Config:
    """The shrunk config of the dataset with its preprocessed directory written by the
    port's pipeline under ``root``."""
    cfg = shrink(make_synthetic_config(synthetic_dataset, root))
    dfs = Pipeline(cfg, device="cpu").run_preprocessing()
    assert (Path(cfg.paths.preprocessed_dir) / "train_metadata.csv").exists() and len(dfs["train"]) > 0
    return cfg


def fresh(cfg: Config, root: Path) -> Config:
    """A copy of ``cfg`` writing under ``root``, the preprocessed directory copied there."""
    cfg = copy.deepcopy(cfg)
    src = Path(cfg.paths.preprocessed_dir)
    cfg.paths.base_output = root
    cfg.paths.__post_init__()
    shutil.copytree(src, cfg.paths.preprocessed_dir)
    cfg.paths.ensure_dirs()
    return cfg


@pytest.fixture(scope="module")
def prepared(synthetic_dataset, tmp_path_factory):
    return preprocessed(synthetic_dataset, tmp_path_factory.mktemp("cli") / "outputs")


def _jax_config(cfg: Config):
    """The JAX package's ``Config`` with every field of the port's ``cfg``."""
    from tpuhar.config import Config as JConfig

    jcfg = JConfig()
    for section in ("paths", "data", "model", "training", "eval", "ood"):
        for key, value in vars(getattr(cfg, section)).items():
            setattr(getattr(jcfg, section), key, value)
    return jcfg


TABLES = ("table3_fewshot", "comparison_probe_vs_finetune", "table4_zeroshot", "table_ood")


def test_full_pipeline(prepared, tmp_path):
    """One pass through every stage; checks each stage's artifact contract."""
    from tpuhar.cli import Pipeline as JPipeline

    cfg = fresh(prepared, tmp_path / "out")
    pipeline = Pipeline(cfg, device="cpu")
    results_dir, ck = Path(cfg.paths.results_dir), Path(cfg.paths.checkpoints_dir)

    trainer = pipeline.run_pretraining()
    assert np.isfinite(trainer.best_metric)
    assert (results_dir / "pretraining_curves.png").exists()
    assert ckpt.checkpoint_exists(ck / "cross_modal" / "best_model")
    assert (ck / "final_model_params.pt").exists()
    hist = json.loads((ck / "cross_modal" / "training_history.json").read_text())
    assert len(hist["train"]) == cfg.training.pretrain_epochs

    zs = pipeline.run_zeroshot()
    assert json.loads((results_dir / "zeroshot_results.json").read_text()) == zs
    assert set(zs["video_prototype_zeroshot"]) >= {"accuracy", "balanced_accuracy"}

    comparison = pipeline.run_classification("both")
    assert set(comparison.index) == {"linear_probe", "finetune"}
    saved = pd.read_csv(results_dir / "classification_comparison.csv", index_col=0)
    assert {"balanced_accuracy", "cal_ece", "cal_mce", "cal_temperature", "cal_ece_scaled"} <= set(saved.columns)
    assert (results_dir / "confusion_linear_probe.png").exists() and (results_dir / "confusion_finetune.png").exists()
    logits = np.load(results_dir / "test_logits_finetune.npy")
    assert logits.shape[1] == cfg.model.num_classes

    raw = pipeline.run_evaluation()
    assert set(raw.columns) >= {"experiment", "n_samples", "run", "mode", "balanced_accuracy"}
    assert len(raw) == 1 * 1 * 2  # samples × runs × modes
    for name in ("fewshot_results_raw.csv", "fewshot_results_agg.csv", "fewshot_table3.csv"):
        assert (results_dir / name).exists(), name

    ood = pipeline.run_ood()
    assert len(ood) == len(cfg.ood.scores)
    assert ood["auroc"].notna().all()
    assert (results_dir / "ood_results.csv").exists() and (results_dir / "ood_results_agg.csv").exists()

    report = pipeline.generate_final_report()
    mine = json.loads((results_dir / "final_report.json").read_text())
    assert {"classification", "few_shot", "ood", "pretraining_history"} <= set(report)
    tables = {name: (results_dir / f"{name}.csv").read_bytes() for name in TABLES}
    # the JAX package's report from the same results directory (it writes over the port's)
    theirs = JPipeline.generate_final_report(types.SimpleNamespace(config=_jax_config(cfg)))
    assert json.loads((results_dir / "final_report.json").read_text()).keys() == mine.keys()
    for d in (mine, theirs):
        d.pop("timestamp")
    assert mine == json.loads(json.dumps(theirs, default=str))
    for name, data in tables.items():
        assert data == (results_dir / f"{name}.csv").read_bytes(), name

    # serve: the raw test split streamed through the finetuned IMU classifier, with OOD
    # decision thresholds calibrated on the val split (id_fpr=0.25)
    n_test = len(pd.read_csv(Path(cfg.paths.preprocessed_dir) / "test_metadata.csv"))
    served = pipeline.run_serving(split="test", batch_size=8, ood_id_fpr=0.25)
    stats = pipeline.serving_stats
    assert len(served) == n_test == stats["windows"] and stats["batches"] == -(-n_test // 8) and stats["seconds"] > 0
    assert set(served.columns) == {"label", "pred", "msp", "energy", "is_ood_msp", "is_ood_energy"}
    assert served["pred"].between(0, cfg.model.num_classes - 1).all()
    assert served["is_ood_msp"].dtype == bool
    # and through the command line, the JAX package's columns without thresholds
    cfg.save(tmp_path / "cfg.json")
    main(["--config", str(tmp_path / "cfg.json"), "--mode", "serve", "--serve-batch", "8", "--device", "cpu"])
    csv = pd.read_csv(results_dir / "serving_predictions_test.csv")
    assert list(csv.columns) == ["label", "pred", "msp", "energy"] and len(csv) == n_test


def test_run_all_skips_existing(prepared, tmp_path, capsys):
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.models.crossmodal import CrossModalModel
    from tpuhar_torch.train.factory import build_crossmodal_task

    cfg = fresh(prepared, tmp_path / "out")
    # fake a pretraining checkpoint so run_all skips pretraining
    task = build_crossmodal_task(cfg, 1, init_params(cfg, torch.Generator().manual_seed(0), CrossModalModel),
                                 device="cpu")
    ckpt.save_checkpoint(Path(cfg.paths.checkpoints_dir) / "cross_modal" / "best_model", task.state,
                         extra={"epoch": 0})
    cfg.ood.enabled = False
    Pipeline(cfg, device="cpu").run_all(classify_mode="linear_probe")
    out = capsys.readouterr().out
    assert "preprocessing artifacts found — skipping" in out
    assert "pretraining checkpoint found — skipping" in out
    for stage in ("zero-shot evaluation", "IMU classification", "few-shot evaluation"):
        assert f"=== Stage: {stage} ===" in out
    assert "=== Stage: preprocessing ===" not in out and "=== Stage: cross-modal pretraining ===" not in out
    assert (Path(cfg.paths.results_dir) / "final_report.json").exists()
    assert not (Path(cfg.paths.results_dir) / "ood_results.csv").exists()


def test_cli_overrides_and_config_roundtrip(tmp_path, monkeypatch):
    from tpuhar.config import Config as JConfig

    for name, cls in (("port", Config), ("jax", JConfig)):
        cfg = cls()
        cfg.paths.base_output = tmp_path / name
        cfg.paths.__post_init__()
        cfg.save(tmp_path / f"{name}.json")
        # `--mode report` is cheap and exercises config load + override plumbing
        pipeline = main(["--mode", "report", "--config", str(tmp_path / f"{name}.json"), "--set", "training.seed=7",
                         "--set", "ood.leave_out_classes=[1, 2]", "--device", "cpu"])
        report = json.loads((tmp_path / name / "results" / "final_report.json").read_text())
        assert report["config"]["training"]["seed"] == pipeline.config.training.seed == 7
        assert report["config"]["ood"]["leave_out_classes"] == [1, 2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="Pipeline on 'cuda' needs a CUDA device"):
        main(["--mode", "report", "--config", str(tmp_path / "port.json")])  # --device cuda is the default
    assert build_parser().parse_args([]).device == "cuda"
    assert "8e" in build_parser().format_help()
