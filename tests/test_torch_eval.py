"""The port's evaluation (``tpuhar_torch/eval/{calibration,evaluator}.py``) against the
JAX package's (``tpuhar/eval/``), on the CPU.

- Calibration: the ECE dict equal (the same float64 numpy); the fitted temperature
  within 1e-3 of the JAX package's relative to it (both sweep the same grid in f32,
  whose NLLs differ in their last bits, and the golden-section search then resolves the
  minimum only to where the NLL's f32 noise hides its curvature).
- ``Evaluator.evaluate`` on the same IMU classifier variables in f32 over the same test
  manifest: predictions and labels equal, logits and embeddings within 1e-5 of their
  largest element, the metrics and the calibration entry equal.
- ``aggregate_results`` and ``create_comparison_table`` equal on a given raw frame;
  ``compare_baseline_vs_pretrained``'s schema; ``save_results_table``'s three formats
  byte for byte.

The synthetic dataset of ``tests/conftest.py`` is preprocessed once for the module by
the JAX package's ``Preprocessor``.
"""
import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_data import port_config

import jax

from tpuhar_torch.data.loader import BatchLoader
from tpuhar_torch.eval import calibration as pcal
from tpuhar_torch.eval.evaluator import Evaluator, FewShotEvaluator, compare_baseline_vs_pretrained, save_results_table
from tpuhar_torch.eval.metrics import _METRICS
from tpuhar_torch.train.factory import build_classification_task

torch.set_num_threads(2)


def _shrink(cfg):
    m = cfg.model
    m.imu_num_layers, m.imu_d_model, m.imu_nhead = 1, 32, 4
    m.classifier_hidden_dims, m.compute_dtype, m.head_norm = [16], "float32", "layer"
    cfg.training.train_epochs = 1
    return cfg


@pytest.fixture(scope="module")
def prepared(synthetic_dataset, tmp_path_factory):
    from tpuhar.data.preprocess import Preprocessor
    from tpuhar.data.synthetic import make_synthetic_config

    jcfg = _shrink(make_synthetic_config(synthetic_dataset, tmp_path_factory.mktemp("eval") / "outputs"))
    dfs = {s: Preprocessor(jcfg).preprocess_split(s, save=True) for s in ("train", "val", "test")}
    return jcfg, dfs


def _logits(seed=0, n=300, c=6):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n)
    logits = rng.normal(0, 2, (n, c)).astype(np.float32)
    logits[np.arange(n), labels] += rng.uniform(0, 4, n).astype(np.float32)  # confident, partly right
    return logits, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibration_matches_jax(seed):
    from tpuhar.eval.calibration import apply_temperature, expected_calibration_error, fit_temperature

    logits, labels = _logits(seed)
    for bins in (10, 15):
        assert pcal.expected_calibration_error(logits, labels, bins) == expected_calibration_error(logits, labels, bins)
    mine, theirs = pcal.fit_temperature(logits, labels), fit_temperature(logits, labels)
    assert abs(mine - theirs) <= 1e-3 * theirs, (mine, theirs)
    scaled = pcal.apply_temperature(torch.from_numpy(logits), mine)
    np.testing.assert_allclose(scaled.numpy(), np.asarray(apply_temperature(logits, mine)), rtol=1e-6)
    assert (scaled.argmax(-1).numpy() == logits.argmax(-1)).all()
    # a temperature that fits lowers the NLL and (on these over-confident logits) the ECE
    after = pcal.expected_calibration_error(scaled.numpy(), labels)["ece"]
    assert after < pcal.expected_calibration_error(logits, labels)["ece"]


def _tasks(prepared):
    """The port's task and the JAX package's on the same fresh IMU classifier tree."""
    from tpuhar.train.factory import build_classification_task as jbuild

    jcfg, _ = prepared
    jtask = jbuild(jcfg, "finetune", 1, jax.random.PRNGKey(0))
    variables = jax.device_get({"params": jtask.state.params, "batch_stats": jtask.state.batch_stats})
    return build_classification_task(port_config(jcfg), "finetune", 1, variables, device="cpu"), jtask


def test_evaluator_matches_jax(prepared, tmp_path):
    from tpuhar.data.loader import BatchLoader as JLoader
    from tpuhar.eval.evaluator import Evaluator as JEvaluator

    jcfg, dfs = prepared
    cfg = port_config(jcfg)
    task, jtask = _tasks(prepared)
    mine = Evaluator(task, cfg).evaluate(BatchLoader(dfs["test"], cfg, mode="classification", batch_size=8, device="cpu"))
    theirs = JEvaluator(jtask, jcfg).evaluate(JLoader(dfs["test"], jcfg, mode="classification", batch_size=8))
    assert len(mine["predictions"]) == len(dfs["test"])  # the padded rows of the last batch dropped
    for key in ("predictions", "labels"):
        assert mine[key].dtype == np.int32
        np.testing.assert_array_equal(mine[key], theirs[key])
    for key in ("logits", "embeddings"):
        assert mine[key].dtype == np.float32 and mine[key].shape == theirs[key].shape
        np.testing.assert_allclose(mine[key], theirs[key], rtol=0, atol=1e-5 * np.abs(theirs[key]).max())
    assert mine["metrics"] == theirs["metrics"]
    assert mine["calibration"] == pytest.approx(theirs["calibration"], rel=1e-5, abs=1e-6)
    assert Evaluator(task, cfg).compute_metrics(mine["labels"], mine["predictions"]) == mine["metrics"]
    # the plot (report.plots, matplotlib) is written, its counts the JAX package's
    from tpuhar.report.plots import plot_confusion_matrix as jax_plot

    png = tmp_path / "confusion.png"
    cm = Evaluator(task, cfg).plot_confusion_matrix(mine["labels"], mine["predictions"], save_path=png)
    assert png.stat().st_size > 0
    np.testing.assert_array_equal(cm, jax_plot(theirs["labels"], theirs["predictions"], jcfg.model.num_classes))


def test_classification_report_matches_jax(prepared):
    from tpuhar.eval.evaluator import Evaluator as JEvaluator

    jcfg, _ = prepared
    task, jtask = _tasks(prepared)
    rng = np.random.default_rng(3)
    y_true, y_pred = rng.integers(0, 4, 40), rng.integers(0, 4, 40)
    pd.testing.assert_frame_equal(
        Evaluator(task, port_config(jcfg)).generate_classification_report(y_true, y_pred, ["a", "b", "c", "d"]),
        JEvaluator(jtask, jcfg).generate_classification_report(y_true, y_pred, ["a", "b", "c", "d"]),
    )


def _raw_results(seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for exp in ("pretrained", "scratch"):
        for n in (10, 20):
            for run in range(3):
                for mode in ("linear_probe", "finetune"):
                    rows.append({"experiment": exp, "n_samples": n, "run": run, "mode": mode,
                                 **{k: float(rng.uniform(0, 100)) for k in _METRICS}})
    return pd.DataFrame(rows)


def test_aggregation_and_comparison_table_match_jax(prepared):
    from tpuhar.eval.evaluator import FewShotEvaluator as JFewShot

    jcfg, _ = prepared
    mine, theirs = FewShotEvaluator(port_config(jcfg), device="cpu"), JFewShot(jcfg)
    raw = _raw_results()
    pd.testing.assert_frame_equal(mine.aggregate_results(raw), theirs.aggregate_results(raw))
    results = {"a": raw[raw["experiment"] == "pretrained"], "b": _raw_results(1)}
    pd.testing.assert_frame_equal(mine.create_comparison_table(results), theirs.create_comparison_table(results))


@pytest.mark.parametrize("fmt", ["csv", "latex", "markdown"])
def test_save_results_table_matches_jax(tmp_path, fmt):
    from tpuhar.eval.evaluator import save_results_table as jsave

    df = _raw_results().head(6)
    save_results_table(df, tmp_path / "mine", fmt)
    jsave(df, tmp_path / "theirs", fmt)
    assert (tmp_path / "mine").read_bytes() == (tmp_path / "theirs").read_bytes()
    with pytest.raises(ValueError, match="Unknown format"):
        save_results_table(df, tmp_path / "x", "xlsx")


def test_compare_baseline_vs_pretrained_schema(prepared, tmp_path):
    """Two variants (scratch, and the encoder of another fresh tree standing for a
    pretrained one), one epoch each: one row per variant, the metric columns."""
    jcfg, dfs = prepared
    cfg = port_config(jcfg)
    cfg.paths.checkpoints_dir = tmp_path / "ck"
    cfg.paths.logs_dir = tmp_path / "logs"
    task, _ = _tasks(prepared)
    from tpuhar_torch.bridge import variables_to_numpy

    encoder = variables_to_numpy(task.model)["params"]["imu_encoder"]
    out = compare_baseline_vs_pretrained(cfg, dfs["train"], dfs["val"], dfs["test"], encoder, verbose=False, device="cpu")
    assert list(out.index) == ["baseline", "pretrained"]
    assert list(out.columns) == list(_METRICS)
    assert ((out.to_numpy() >= 0) & (out.to_numpy() <= 100)).all()
    assert (tmp_path / "ck" / "compare_pretrained" / "best_model.pt").exists()


def test_confusion_update_drops_out_of_range_rows_as_jax():
    """A label or prediction outside ``[-C, C)`` adds nothing, a negative one counts from
    the end, as the JAX package's scatter does: the leave-one-out harness evaluates its
    OOD rows with the held-out label, which is ``C`` when the last class is held out
    (the port raised an IndexError there)."""
    import jax.numpy as jnp

    from tpuhar.eval.metrics import confusion_update as jupdate
    from tpuhar.eval.metrics import init_confusion as jinit
    from tpuhar_torch.eval.metrics import confusion_update, init_confusion

    labels, preds = np.array([0, 3, 1, -1, 2, 5]), np.array([0, 1, 3, 2, -3, 0])
    valid = np.array([True, True, True, True, True, False])
    got = confusion_update(init_confusion(3), torch.from_numpy(labels), torch.from_numpy(preds), torch.from_numpy(valid))
    want = jupdate(jinit(3), jnp.asarray(labels), jnp.asarray(preds), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
