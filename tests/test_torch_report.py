"""The port's reports and utilities (``tpuhar_torch/report/{tables,plots}.py``,
``tpuhar_torch/utils``) against the JAX package's, on the CPU.

- Tables: every table equal to the JAX package's DataFrame
  (``pd.testing.assert_frame_equal``) on ``make_demo_results`` and on one results
  directory holding each artifact the article tables read; the files
  ``save_tables`` writes (CSV, LaTeX, Markdown) byte for byte; the LaTeX and README
  strings equal.
- Plots: each writes its PNG; the confusion counts equal the JAX package's.
- Utilities: the same values as the JAX package's for the same inputs (the parameter
  counts of one tree as numpy arrays, as tensors and as the loaded ``nn.Module``); what
  differs by design: ``set_seed`` returns a ``torch.Generator``, the devices are
  ``torch.device``s, ``trace`` writes a Chrome trace.
"""
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from tpuhar_torch import utils as pu
from tpuhar_torch.report import plots as pplots
from tpuhar_torch.report import tables as pt
from tpuhar_torch.utils import profiling as pprof

torch.set_num_threads(2)


def _results_dir(root: Path) -> Path:
    """A results directory with every artifact the article tables read."""
    from tpuhar.report.tables import make_demo_results as jax_demo

    root.mkdir(parents=True)
    jax_demo(seed=3).to_csv(root / "fewshot_results_raw.csv", index=False)
    (root / "zeroshot_results.json").write_text(json.dumps(
        {"video_prototype_zeroshot": {"accuracy": 41.5, "balanced_accuracy": 40.25, "f1_macro": 39.0}}))
    pd.DataFrame({"config": ["baseline", "stft", "cnn"], "accuracy": [50.0, 52.5, 48.125],
                  "balanced_accuracy": [49.0, 51.0, 47.5]}).to_csv(root / "ablation_results.csv", index=False)
    pd.DataFrame({"held_out_class": [0, 0, 1], "score": ["msp", "energy", "msp"], "auroc": [0.7, 0.75, 0.6],
                  "fpr_at_95tpr": [0.5, 0.4, 0.7]}).to_csv(root / "ood_results.csv", index=False)
    return root


def test_demo_results_and_tables_match_jax(tmp_path):
    from tpuhar.report import tables as jt

    for seed in (0, 7):
        pd.testing.assert_frame_equal(pt.make_demo_results(seed), jt.make_demo_results(seed))
    df = pt.make_demo_results(0)
    mine, theirs = pt.TableGenerator(tmp_path / "mine"), jt.TableGenerator(tmp_path / "theirs")
    pd.testing.assert_frame_equal(mine.generate_table3_style(df), theirs.generate_table3_style(df))
    pd.testing.assert_frame_equal(mine.generate_table3_style(df, "f1_macro"), theirs.generate_table3_style(df, "f1_macro"))
    pd.testing.assert_frame_equal(mine.create_comparison_table(df), theirs.create_comparison_table(df))
    zs = {"a": {"accuracy": 1.0, "f1": 2.0}, "b": {"accuracy": 3.0, "f1": 4.0}}
    pd.testing.assert_frame_equal(mine.generate_table4_style(zs), theirs.generate_table4_style(zs))
    ab = pd.DataFrame({"config": ["x", "y"], "acc": [1.0, 2.0]})
    pd.testing.assert_frame_equal(mine.generate_table5_style(ab), theirs.generate_table5_style(ab))
    pd.testing.assert_frame_equal(mine.generate_table5_style(ab[["acc"]]), theirs.generate_table5_style(ab[["acc"]]))
    assert pt.format_mean_std(1.2345, float("nan")) == jt.format_mean_std(1.2345, float("nan")) == "1.23"
    assert pt.format_mean_std(1.2345, 0.5, 3) == jt.format_mean_std(1.2345, 0.5, 3)


def test_article_tables_from_one_results_directory_match_jax(tmp_path):
    from tpuhar.report import tables as jt

    results = _results_dir(tmp_path / "results")
    mine = pt.create_article_tables_from_results(results, tmp_path / "mine")
    theirs = jt.create_article_tables_from_results(results, tmp_path / "theirs")
    assert sorted(mine) == sorted(theirs) == [
        "comparison_probe_vs_finetune", "table3_fewshot", "table4_zeroshot", "table5_ablation", "table_ood"]
    for name in mine:
        pd.testing.assert_frame_equal(mine[name], theirs[name])
        for suffix in (".csv", ".tex", ".md"):
            a = (tmp_path / "mine" / f"{name}{suffix}").read_bytes()
            assert a and a == (tmp_path / "theirs" / f"{name}{suffix}").read_bytes(), (name, suffix)
    assert pt.format_results_for_readme(mine) == jt.format_results_for_readme(theirs)
    for name, df in mine.items():
        assert pt.create_latex_paper_table(df, caption=f"Results {name}") == \
            jt.create_latex_paper_table(df, caption=f"Results {name}")
    assert pt.create_latex_paper_table(mine["table5_ablation"], label="abl") == \
        jt.create_latex_paper_table(theirs["table5_ablation"], label="abl")
    assert pt.create_article_tables_from_results(tmp_path / "empty") == {}


def test_a_malformed_artifact_is_skipped_as_in_jax(tmp_path, capsys):
    from tpuhar.report import tables as jt

    (tmp_path / "fewshot_results_raw.csv").write_text("a,b\n1,2\n")
    assert pt.create_article_tables_from_results(tmp_path) == jt.create_article_tables_from_results(tmp_path) == {}
    out = capsys.readouterr().out
    assert out.count("[tables] Table 3 failed") == 2


def test_plots_are_written(tmp_path):
    from tpuhar.report import plots as jp

    rng = np.random.default_rng(0)
    y_true, y_pred = rng.integers(0, 5, 60), rng.integers(0, 5, 60)
    cm = pplots.plot_confusion_matrix(y_true, y_pred, 5, save_path=tmp_path / "cm.png")
    np.testing.assert_array_equal(cm, jp.plot_confusion_matrix(y_true, y_pred, 5))
    assert cm.sum() == 60 and cm.dtype == np.int64
    pplots.plot_training_curves({"train": [3.0, 2.0, 1.5], "val": [3.1, 2.5, 2.0]}, tmp_path / "a" / "curves.png")
    pplots.plot_training_curves({"train": [{"loss": 1.0}, {"loss": 0.5}], "val": []}, tmp_path / "cls.png")
    pplots.plot_metric_curves({"train": [{"acc": 1.0}, {"acc": 2.0}], "val": [{"acc": 0.5}]}, "acc", tmp_path / "m.png")
    pplots.visualize_imu_window(rng.normal(size=(6, 250)), tmp_path / "w.png")
    for name in ("cm.png", "a/curves.png", "cls.png", "m.png", "w.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name


def test_utilities_match_jax(tmp_path, synthetic_dataset):
    import jax
    import jax.numpy as jnp

    from tpuhar import utils as ju

    from tpuhar_torch.bridge import init_params, load_variables
    from tpuhar_torch.config import Config
    from tpuhar_torch.models.crossmodal import IMUClassifier

    gen = pu.set_seed(11)
    assert isinstance(gen, torch.Generator) and gen.device.type == "cpu"
    assert torch.equal(torch.randint(0, 1000, (4,), generator=gen),
                       torch.randint(0, 1000, (4,), generator=torch.Generator().manual_seed(11)))
    assert np.random.rand() == (ju.set_seed(11), np.random.rand())[1]  # numpy seeded as the JAX package seeds it

    cfg = Config()
    cfg.model.imu_num_layers, cfg.model.imu_d_model, cfg.model.imu_nhead = 1, 32, 4
    cfg.model.compute_dtype = "float32"
    variables = init_params(cfg, torch.Generator().manual_seed(0), IMUClassifier)
    tree = variables["params"]
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    n = ju.count_parameters(jtree)
    tensors = {k: v for k, v in torch.utils._pytree.tree_map(torch.from_numpy, tree).items()}
    model = load_variables(IMUClassifier(cfg), variables)
    assert pu.count_parameters(tree) == pu.count_parameters(tensors) == pu.count_parameters(model) == n > 0
    assert pu.param_bytes(tree) == pu.param_bytes(model) == ju.param_bytes(jtree) == 4 * n

    from tpuhar.config import Config as JConfig

    mine, theirs = Config(), JConfig()
    mine.paths.base_input = theirs.paths.base_input = synthetic_dataset
    assert pu.check_dataset_paths(mine) == ju.check_dataset_paths(theirs) and pu.check_dataset_paths(mine)["ok"]
    mine.paths.base_input = theirs.paths.base_input = synthetic_dataset / "absent"
    assert pu.check_dataset_paths(mine) == ju.check_dataset_paths(theirs) and not pu.check_dataset_paths(mine)["ok"]

    for s in (5.25, 61, 3599, 3600, 7322.5):
        assert pu.format_time(s) == ju.format_time(s)
    assert pu.estimate_training_time(100, 3, 0.5) == ju.estimate_training_time(100, 3, 0.5)
    metrics = {"accuracy": 91.25, "f1_macro": 88.0}
    assert pu.format_metric_table(metrics, "t") == ju.format_metric_table(metrics, "t")
    assert pu.format_metric_table({}) == ju.format_metric_table({})

    meter, jmeter = pu.AverageMeter("x"), ju.AverageMeter("x")
    for v, k in ((1.0, 2), (4.0, 1), (2.5, 3)):
        meter.update(v, k)
        jmeter.update(v, k)
    assert vars(meter) == vars(jmeter)
    timer = pu.StepTimer(warmup=1)
    for _ in range(3):
        timer.start()
        timer.stop()
    assert len(timer._times) == 2 and timer.mean >= 0 and timer.p50 >= 0
    assert pu.StepTimer().mean == pu.StepTimer().p50 == 0.0

    summary = {"a": np.float32(1.5), "b": np.int64(3), "c": np.arange(3), "d": torch.tensor([1.0, 2.0]), "e": Path("x")}
    pu.create_results_summary(summary, tmp_path / "mine.json")
    ju.create_results_summary({**summary, "d": np.array([1.0, 2.0])}, tmp_path / "theirs.json")
    assert (tmp_path / "mine.json").read_text() == (tmp_path / "theirs.json").read_text()
    pu.save_config(cfg, tmp_path / "cfg.json")
    assert Config.load(tmp_path / "cfg.json").model.imu_d_model == 32


def test_devices_and_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pu.get_devices() == pu.get_devices("cuda") == pu.get_devices("cpu") == [torch.device("cpu")]
    assert pu.describe_devices() == "1x cpu"
    assert pu.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="Thing on 'cuda' needs a CUDA device"):
        pu.resolve_device("cuda", "Thing")
    pu.print_model_info("m", {"w": np.zeros((3, 4), np.float32)})
    assert capsys.readouterr().out == "m: 12 parameters (0.00 MB)\n"

    with pprof.trace(tmp_path / "prof") as prof:
        with pprof.annotate("phase_a"):
            torch.ones(64).sum()
    trace = json.loads((tmp_path / "prof" / pprof.TRACE_FILENAME).read_text())
    assert any(e.get("name") == "phase_a" for e in trace["traceEvents"])
    assert prof is not None
    with pytest.raises(ZeroDivisionError):  # the trace is written when the block raises
        with pprof.trace(tmp_path / "raised"):
            1 / 0
    assert (tmp_path / "raised" / pprof.TRACE_FILENAME).exists()
    with pprof.trace(tmp_path / "off", enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
