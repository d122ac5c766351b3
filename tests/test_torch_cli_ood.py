"""The port's pipeline on the CPU, continued (``tests/test_pipeline.py``'s OOD contracts
and the module entry point):

- ``ood.model_kind="fusion"``: the leave-one-out trains fusion classifiers (IMU and
  video) and scores the fused embedding;
- ``run_loo_experiments(reuse_checkpoints=True)`` scores a finished ``ood_loo_{c}``
  checkpoint instead of training again: equal rows, the checkpoint not rewritten;
- ``python -m tpuhar_torch --device cpu --mode all`` from the raw files, then ``--mode
  serve``, in a process where JAX cannot be imported; ``--device cuda`` there fails.

The conftest's synthetic dataset is preprocessed once for the module by the port's
pipeline.
"""
import json
import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest
import torch
from test_torch_cli import fresh, preprocessed, shrink

from tpuhar_torch.cli import Pipeline
from tpuhar_torch.data.synthetic import make_synthetic_config
from tpuhar_torch.ood import OODEvaluator

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def prepared(synthetic_dataset, tmp_path_factory):
    return preprocessed(synthetic_dataset, tmp_path_factory.mktemp("cli_ood") / "outputs")


def test_ood_fusion_model_kind(prepared, tmp_path):
    cfg = fresh(prepared, tmp_path / "out")
    cfg.ood.model_kind = "fusion"
    cfg.ood.leave_out_classes = [0]
    cfg.training.train_epochs = 1
    cfg.model.fusion_heads = 4
    ood = Pipeline(cfg, device="cpu").run_ood()
    assert len(ood) == len(cfg.ood.scores)
    assert ood["auroc"].notna().all()
    assert (ood["auroc"] <= 1.0).all() and (ood["auroc"] >= 0.0).all()
    assert (Path(cfg.paths.checkpoints_dir) / "ood_loo_0" / "last.pt").exists()


def test_ood_loo_reuse_checkpoints(prepared, tmp_path):
    cfg = fresh(prepared, tmp_path / "out")
    cfg.training.train_epochs = 1
    dfs = [pd.read_csv(Path(cfg.paths.preprocessed_dir) / f"{s}_metadata.csv") for s in ("train", "val", "test")]

    first = OODEvaluator(cfg, torch.Generator().manual_seed(7), device="cpu").run_loo_experiments(*dfs)
    ckpt_dir = Path(cfg.paths.checkpoints_dir) / "ood_loo_0"
    assert (ckpt_dir / "training_history.json").exists()
    mtime = (ckpt_dir / "last.pt").stat().st_mtime_ns
    second = OODEvaluator(cfg, torch.Generator().manual_seed(7), device="cpu").run_loo_experiments(
        *dfs, reuse_checkpoints=True
    )
    assert (ckpt_dir / "last.pt").stat().st_mtime_ns == mtime  # not retrained
    pd.testing.assert_frame_equal(
        first.sort_values("score").reset_index(drop=True), second.sort_values("score").reset_index(drop=True)
    )


_RUN = """
import runpy, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None  # the port's command line needs none of them
sys.argv = ["tpuhar_torch"] + sys.argv[1:]
runpy.run_module("tpuhar_torch", run_name="__main__", alter_sys=True)
jax_package = sorted(m for m in sys.modules if m == "tpuhar" or m.startswith("tpuhar."))
assert not jax_package, jax_package
"""


def test_python_m_tpuhar_torch_runs_all_from_raw_files(synthetic_dataset, tmp_path):
    cfg = shrink(make_synthetic_config(synthetic_dataset, tmp_path / "out"))
    cfg.training.pretrain_epochs = cfg.training.train_epochs = 1
    cfg.save(tmp_path / "cfg.json")
    base = [sys.executable, "-c", _RUN, "--config", str(tmp_path / "cfg.json")]

    def run(*args):
        return subprocess.run(base + list(args), cwd=ROOT, capture_output=True, text=True, timeout=600)

    proc = run("--mode", "all", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-4000:]
    for stage in ("preprocessing", "cross-modal pretraining", "zero-shot evaluation", "IMU classification",
                  "few-shot evaluation", "OOD leave-one-activity-out"):
        assert f"=== Stage: {stage} ===" in proc.stdout, stage
    results = tmp_path / "out" / "results"
    report = json.loads((results / "final_report.json").read_text())
    assert {"classification", "few_shot", "ood", "pretraining_history"} <= set(report)
    for name in ("classification_comparison.csv", "zeroshot_results.json", "ood_results_agg.csv", "table3_fewshot.csv"):
        assert (results / name).exists(), name
    assert json.loads((tmp_path / "out" / "preprocessed" / "preprocessing_stats.json").read_text())["total_windows"] > 0

    proc = run("--mode", "serve", "--serve-batch", "16", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[Serve]" in proc.stdout and (results / "serving_predictions_test.csv").exists()

    if not torch.cuda.is_available():
        proc = run("--mode", "report")  # the default device, cuda
        assert proc.returncode != 0 and "needs a CUDA device" in proc.stderr
