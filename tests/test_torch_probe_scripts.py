"""The research probes and debug scripts of ``tpuhar_torch/scripts/`` against the JAX
package's ``scripts/``, on the CPU.

- Arguments: the JAX scripts read ``sys.argv`` by position (``sys.argv[i] if
  len(sys.argv) > i else default``); each port module takes the same positions with the
  same defaults and types, and ``--cpu``, and nothing else. Defaults that name an
  output tree move from ``outputs/X`` to ``outputs/torch/X``.
- The collapse, drift and summary statistics against the JAX scripts' numpy formulas on
  the same arrays.
- The probe's logistic regression against ``sklearn.linear_model.LogisticRegression(
  max_iter=2000)`` on the same embeddings and split: at least 99% of the held-out
  predictions equal, the balanced accuracy within 1 point, the coefficients within 2% of
  sklearn's largest and the intercepts within 0.05 (both stop at a gradient of 1e-4, and
  sklearn fits float32 input in float32, so neither is the exact minimizer: here they
  differ by 0.4-0.8% of the largest coefficient and by up to 0.03 in an intercept). Six
  classes (the multinomial model) and two (the binary one).
- ``debug_pretrain_parity``'s ``cpu_f32`` arm against the JAX script's on the same pool
  and initial state (JAX's ``PRNGKey(0)`` init carried across), 2 steps at dropout 0 with
  narrow widths (both configurations shrunk by the same patch of
  ``make_synthetic_config``): the gradient norm at init to 1e-4 relative, the
  embeddings' spread to 2e-6 and the losses to 2e-4 (f32 sums in another order, plus the
  JAX script's rounding to 6 and 4 decimals).
- ``debug_ckpt_data_match`` on a checkpoint the port saved from a variable tree, against
  the JAX script's forward ``model.apply(variables, imu, normalize_clip(video_u8))`` of
  the same tree on the same rows: the same predictions and confusion matrix, the logits
  to 1e-4. Both in f32 at 2 frames of 32² with narrow widths, so that rounding cannot
  swap an argmax.
- ``measure_resident_drift``'s per-seed function on the CPU at seed 0, on JAX's seed-0
  variables, within ``tests/test_torch_serving.py``'s bounds on the resident engine
  (relative RMS drift < 0.10, correlation > 0.99).
"""
import ast
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ("measure_resident_drift", "debug_ckpt_data_match", "debug_pretrain_parity", "debug_pretrain_loop",
           "probe_pretrain_collapse", "probe_imu_hard_lr", "probe_coupling_strength")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_positionals(path):
    """``[(index, default, type)]`` of ``sys.argv[index] if len(sys.argv) > index else
    default`` in a JAX script, ``type`` ``int`` where the value is wrapped in ``int()``."""
    found = {}
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if not isinstance(node, ast.IfExp):
            continue
        body, kind = node.body, None
        if isinstance(body, ast.Call) and ast.unparse(body.func) == "int" and len(body.args) == 1:
            body, kind = body.args[0], int
        if isinstance(body, ast.Subscript) and ast.unparse(body.value) == "sys.argv":
            found[body.slice.value] = (body.slice.value, node.orelse.value, kind)
    return [found[i] for i in sorted(found)]


def _port_default(value):
    return value.replace("outputs/", "outputs/torch/", 1) if isinstance(value, str) and value.startswith("outputs/") else value


@pytest.mark.parametrize("name", SCRIPTS)
def test_positional_arguments_match_the_jax_script(name):
    want = _jax_positionals(ROOT / "scripts" / f"{name}.py")
    assert want or name == "probe_coupling_strength"
    mod = importlib.import_module(f"tpuhar_torch.scripts.{name}")
    parser = {}

    class Grab(Exception):
        pass

    real = mod.argparse.ArgumentParser.parse_args

    def grab(self, *args, **kwargs):
        parser["p"] = self
        raise Grab

    mod.argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(Grab):
            mod.parse_args([])
    finally:
        mod.argparse.ArgumentParser.parse_args = real
    actions = [a for a in parser["p"]._actions if a.dest != "help"]
    positional = [a for a in actions if not a.option_strings]
    assert [(a.nargs, a.default, a.type) for a in positional] == [("?", _port_default(d), t) for _, d, t in want]
    (cpu,) = [a for a in actions if a.option_strings]
    assert cpu.option_strings == ["--cpu"] and cpu.default is False and cpu.const is True
    # the JAX script's argv, and --cpu, parse to those values
    argv = [str(d) for _, d, _ in want]
    got = mod.parse_args(argv + ["--cpu"])
    assert got.cpu is True and [getattr(got, a.dest) for a in positional] == [t(v) if t else v for v, (_, _, t) in zip(argv, want)]


# ---------------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------------
def test_collapse_stats_match_the_jax_formulas():
    from tpuhar_torch.scripts.probe_pretrain_collapse import collapse_stats

    for seed, scale in ((0, 1.0), (1, 1e-3)):
        F = np.random.default_rng(seed).normal(3.0, scale, (50, 16)).astype(np.float32)
        # scripts/probe_pretrain_collapse.py:68-70, 82-83
        Fc = F - F.mean(0)
        var = float((Fc**2).sum(1).mean())
        norm2 = float((F**2).sum(1).mean())
        want = {"perdim_std": round(float(F.std(0).mean()), 4), "var_over_norm2": round(var / max(norm2, 1e-9), 5)}
        assert collapse_stats(F) == want


def test_drift_stats_and_summary_match_the_jax_formulas():
    from tpuhar_torch.scripts.measure_resident_drift import drift_stats, summary

    rng = np.random.default_rng(2)
    rows = []
    for seed in range(3):
        base = rng.standard_normal((4, 5)).astype(np.float32)
        res = base + rng.normal(0, 0.05 * (seed + 1), base.shape).astype(np.float32)
        # scripts/measure_resident_drift.py:71-76
        b, r = np.asarray(base, np.float64), np.asarray(res, np.float64)
        corr = float(np.corrcoef(r.ravel(), b.ravel())[0, 1])
        spread = float(np.sqrt(np.mean((b - b.mean()) ** 2)))
        rel = float(np.sqrt(np.mean((r - b) ** 2)) / max(spread, 1e-12))
        assert drift_stats(base, res) == {"corr": corr, "rel_rms_drift": rel}
        rows.append({"seed": seed, "corr": corr, "rel_rms_drift": rel})
    corrs, rels = np.array([r["corr"] for r in rows]), np.array([r["rel_rms_drift"] for r in rows])
    want = {  # :78-88
        "n_seeds": 3, "corr": {"min": corrs.min(), "median": float(np.median(corrs))},
        "rel_rms_drift": {"min": rels.min(), "median": float(np.median(rels)), "max": rels.max()}, "rows": rows,
    }
    assert json.dumps(summary(rows)) == json.dumps(want)


@pytest.mark.parametrize("classes", [6, 2])
def test_logistic_regression_matches_sklearn(classes):
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import balanced_accuracy_score

    from tpuhar_torch.scripts.probe_pretrain_collapse import (
        balanced_accuracy,
        fit_logistic_regression,
        predict_logistic_regression,
        probe_heldout,
    )

    rng = np.random.default_rng(classes)
    centers = rng.normal(0, 1.0, (classes, 64))
    labels = np.repeat(np.arange(classes), 132 // classes)
    F = (centers[labels] + rng.normal(0, 2.0, (len(labels), 64))).astype(np.float32)
    # the JAX script's split and fit (scripts/probe_pretrain_collapse.py:76-80)
    idx = np.random.default_rng(0).permutation(len(F))
    tr_i, te_i = idx[: len(F) // 2], idx[len(F) // 2:]
    clf = LogisticRegression(max_iter=2000).fit(F[tr_i], labels[tr_i])
    want_pred = clf.predict(F[te_i])
    want_bal = balanced_accuracy_score(labels[te_i], want_pred) * 100

    coef, intercept, cls = fit_logistic_regression(F[tr_i], labels[tr_i])
    got_pred = predict_logistic_regression(coef, intercept, cls, F[te_i])
    assert coef.shape == clf.coef_.shape and np.array_equal(cls, clf.classes_)
    assert np.mean(got_pred == want_pred) >= 0.99
    assert abs(probe_heldout(F, labels) - want_bal) <= 1.0
    assert balanced_accuracy(labels[te_i], want_pred) * 100 == pytest.approx(want_bal, abs=1e-12)
    assert np.abs(coef - clf.coef_).max() <= 2e-2 * np.abs(clf.coef_).max()
    # the unpenalized intercepts are the least determined direction: sklearn's own moved
    # by 0.029 between tol 1e-4 and 1e-10 on these embeddings
    assert np.abs(intercept - clf.intercept_).max() <= 5e-2


# ---------------------------------------------------------------------------------
# the pretraining parity probe
# ---------------------------------------------------------------------------------
def _shrink(cfg):
    """Narrow widths, dropout 0 and batches of 8, for both packages' configs."""
    m = cfg.model
    m.imu_d_model, m.imu_nhead, m.imu_num_layers, m.imu_dropout = 32, 4, 1, 0.0
    m.projection_dim, m.projection_hidden_dim = 16, 32
    m.classifier_hidden_dims, m.fusion_heads = [16], 4
    cfg.training.pretrain_batch_size = 8
    return cfg


def _shrunk(monkeypatch, *modules):
    for mod in modules:
        real = mod.make_synthetic_config
        monkeypatch.setattr(mod, "make_synthetic_config", lambda *a, _real=real, **kw: _shrink(_real(*a, **kw)))


@pytest.fixture(scope="module")
def pool(synthetic_dataset, tmp_path_factory):
    """``<work>/pool``: the conftest's dataset preprocessed by the port at the parity
    probe's configuration (``tiny_cnn``, 4 frames of 32²)."""
    from tpuhar_torch.data.preprocess import Preprocessor
    from tpuhar_torch.scripts.debug_pretrain_parity import parity_config

    work = tmp_path_factory.mktemp("article_hard_r5")
    (work / "pool").mkdir()
    (work / "pool" / "data").symlink_to(synthetic_dataset)
    cfg = parity_config(work / "pool")
    cfg.data.featurize_backend = "host"
    Preprocessor(cfg, device="cpu").run_full_preprocessing()
    return work


def test_pretrain_parity_cpu_arm_matches_jax(pool, tmp_path, monkeypatch):
    import jax

    import tpuhar.data.synthetic as jax_synthetic
    import tpuhar.train.factory as jax_factory
    import tpuhar_torch.data.synthetic as port_synthetic
    from tpuhar_torch.scripts import debug_pretrain_parity

    _shrunk(monkeypatch, jax_synthetic, port_synthetic)
    # the factory's flax init under jax.jit: the same PRNGKey(0) draws, one compile in
    # place of an eager init's hundreds
    model_cls = jax_factory.CrossModalModel

    class JitInit(model_cls):
        def init(self, rng, *args):
            return jax.jit(lambda r, *a: model_cls.init(self, r, *a))(rng, *args)

    monkeypatch.setattr(jax_factory, "CrossModalModel", JitInit)
    init = {}
    build = jax_factory.build_crossmodal_task

    def spy(*args, **kwargs):
        task = build(*args, **kwargs)
        init["state"] = jax.device_get(task.state)
        return task

    monkeypatch.setattr(jax_factory, "build_crossmodal_task", spy)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "docs").mkdir()
    monkeypatch.setattr(sys, "argv", ["debug_pretrain_parity.py", "2", str(pool)])
    _load("jax_debug_pretrain_parity", ROOT / "scripts" / "debug_pretrain_parity.py").main()
    want = json.loads((tmp_path / "docs" / "pretrain_parity.json").read_text())

    state = init["state"]
    params = {"params": state.params, "batch_stats": state.batch_stats or {}}
    got = debug_pretrain_parity.run(2, pool, device="cpu", params=params, out=tmp_path / "port.json")
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert set(got) == set(want) and got["steps"] == 2 and set(got["arms"]) == set(want["arms"]) == {"cpu_f32"}
    g, w = got["arms"]["cpu_f32"], want["arms"]["cpu_f32"]
    assert set(g) == set(w)
    assert g["grad_norm_step0"] == pytest.approx(w["grad_norm_step0"], rel=1e-4, abs=1e-6)
    for k, v in w["init_emb_std"].items():
        assert abs(g["init_emb_std"][k] - v) <= 2e-6, k
    for key in ("loss_first5", "loss_last5"):
        assert len(g[key]) == len(w[key]) == 2
        np.testing.assert_allclose(g[key], w[key], rtol=0, atol=2e-4, err_msg=key)
    assert abs(g["loss_final"] - w["loss_final"]) <= 2e-4


def test_pretrain_loop_logs_each_batch_and_restores_the_trainer(pool, tmp_path, monkeypatch, capfd):
    import tpuhar_torch.data.synthetic as port_synthetic
    from tpuhar_torch.scripts import debug_pretrain_loop
    from tpuhar_torch.train.loop import CrossModalTrainer

    _shrunk(monkeypatch, port_synthetic)
    work = tmp_path / "work"
    (work / "pool" / "out").mkdir(parents=True)
    (work / "pool" / "data").symlink_to(pool / "pool" / "data")
    (work / "pool" / "out" / "preprocessed").symlink_to(pool / "pool" / "out" / "preprocessed")
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on the card's host
    epoch = CrossModalTrainer.train_epoch
    out = debug_pretrain_loop.run(work, device="cpu", epochs=1)
    assert CrossModalTrainer.train_epoch is epoch
    assert set(out) == {"bench", "train", "val"} and len(out["train"]) == len(out["val"]) == 1
    err = capfd.readouterr().err
    assert "[instrument] batch 0: loss=" in err and "[instrument] epoch first5=" in err


# ---------------------------------------------------------------------------------
# the checkpoint rescoring script
# ---------------------------------------------------------------------------------
def test_ckpt_data_match_confusion_matches_jax(synthetic_dataset, tmp_path, monkeypatch, capsys):
    import jax

    import tpuhar.data.synthetic as jax_synthetic
    import tpuhar_torch.data.synthetic as port_synthetic
    from tpuhar.data.loader import BatchLoader as JaxLoader
    from tpuhar.models.crossmodal import FusionClassifier as JaxFusion
    from tpuhar.ops.video import normalize_clip as jax_normalize
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.data.preprocess import Preprocessor
    from tpuhar_torch.models.crossmodal import FusionClassifier
    from tpuhar_torch.scripts import debug_ckpt_data_match
    from tpuhar_torch.train import checkpoint as ckpt
    from tpuhar_torch.train.factory import build_fusion_task

    def f32(cfg):
        cfg.model.compute_dtype = "float32"
        return _shrink(cfg)

    for mod in (jax_synthetic, port_synthetic):
        real = mod.make_synthetic_config
        monkeypatch.setattr(mod, "make_synthetic_config", lambda *a, _real=real, **kw: f32(_real(*a, **kw)))
    root, tower, n = tmp_path / "bench", "tpu_cnn", 20
    (root / "fixture").parent.mkdir(parents=True)
    (root / "fixture").symlink_to(synthetic_dataset)
    kw = dict(num_classes=4, video_backbone=tower, video_resize=(32, 32), train_epochs=4, train_batch_size=16)
    cfg = port_synthetic.make_synthetic_config(root / "fixture", root / tower, **kw)
    cfg.data.video_frames_per_window, cfg.data.featurize_backend = 2, "host"
    cfg.paths.preprocessed_dir = root / "preprocessed"
    Preprocessor(cfg, device="cpu").preprocess_split("test")
    variables = init_params(cfg, torch.Generator().manual_seed(3), FusionClassifier)
    ck = root / tower / "checkpoints" / "fusion_full"
    ckpt.save_checkpoint(ck / "last", build_fusion_task(cfg, 1, variables, device="cpu").state)
    (ck / "training_history.json").write_text(json.dumps(
        {"train": [{"loss": 1.5, "accuracy": 40.0}], "val": [{"loss": 1.4, "balanced_accuracy": 45.0, "f1_macro": 1.0}]}))

    got = debug_ckpt_data_match.run(root, tower, n, device="cpu", num_classes=4, frames=2, resize=32)
    printed = capsys.readouterr().out
    assert got["training_last_epoch"] == {"train_loss": 1.5, "train_accuracy": 40.0, "val_loss": 1.4,
                                          "val_balanced_accuracy": 45.0}
    assert f"current-data acc over {len(got['labels'])}: {got['accuracy']:.2f}%" in printed
    assert "confusion (rows=true):" in printed

    # the JAX script's forward (scripts/debug_ckpt_data_match.py:63-79) of the same tree
    jcfg = jax_synthetic.make_synthetic_config(root / "fixture", root / tower, **kw)
    jcfg.data.video_frames_per_window, jcfg.data.featurize_backend = 2, "host"
    jcfg.paths.preprocessed_dir = root / "preprocessed"
    import pandas as pd

    model = JaxFusion(jcfg)
    fwd = jax.jit(lambda imu, video_u8: model.apply(variables, imu, jax_normalize(video_u8), train=False))
    logits, labels = [], []
    for b in JaxLoader(pd.read_csv(root / "preprocessed" / "test_metadata.csv").head(n), jcfg, mode="fusion",
                       batch_size=16, prefetch=0):
        k = int(b["n_valid"])
        logits.append(np.asarray(fwd(b["imu"], b["video"])[0])[:k])
        labels.append(np.asarray(b["label"])[:k])
    logits, labels = np.concatenate(logits), np.concatenate(labels)
    preds = np.argmax(logits, 1)
    cm = np.zeros((4, 4), int)
    for p, t in zip(preds, labels):
        cm[t, p] += 1
    assert len(labels) == n
    np.testing.assert_array_equal(got["labels"], labels)
    np.testing.assert_array_equal(np.argmax(got["logits"], 1), preds)
    np.testing.assert_array_equal(got["confusion"], cm)
    assert got["accuracy"] == pytest.approx(float((preds == labels).mean()) * 100)
    np.testing.assert_allclose(got["logits"], logits, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------------
# the resident drift
# ---------------------------------------------------------------------------------
def test_resident_drift_seed0_on_jax_variables():
    import jax
    import jax.numpy as jnp

    from tpuhar.models.crossmodal import FusionClassifier as JaxFusion
    from tpuhar_torch.scripts.measure_resident_drift import seed_row

    jax_script = _load("jax_measure_resident_drift", ROOT / "scripts" / "measure_resident_drift.py")
    cfg = jax_script._cfg()  # the JAX script's configuration
    variables = jax.device_get(jax.jit(JaxFusion(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 6, 250)), jnp.zeros((2, 4, 32, 32, 3))))
    row = seed_row(variables, 0, device="cpu")
    assert set(row) == {"seed", "corr", "rel_rms_drift"} and row["seed"] == 0
    assert row["rel_rms_drift"] < 0.10 and row["corr"] > 0.99
