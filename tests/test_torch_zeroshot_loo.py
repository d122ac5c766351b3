"""The port's zero-shot pass, leave-one-activity-out harness and ablation harness
(``tpuhar_torch/eval/{zeroshot,ablation}.py``, ``tpuhar_torch/ood.py``) against the JAX
package's, on the CPU.

- Zero-shot on the same ``CrossModalModel`` variables (``tiny_cnn`` tower, f32): the
  prototypes within 1e-5 (unit vectors), the metrics equal; the IMU projection the port
  takes from the IMU tower alone equals, bit for bit, the full model's on the
  un-normalized zero clip the JAX package feeds beside each window (its only
  departure, ROADMAP §3).
- ``leave_one_out_split`` equal, with and without a shared remap and with dropped rows.
- ``OODEvaluator``: the rows' schema for the IMU and the fusion classifier, and per
  held-out class each score's AUROC and FPR equal to those of the JAX package's
  scorers on the same embeddings (reusing the class's finished checkpoint).
- ``_apply_overrides`` and a two-variant ``run_ablations``.
"""
import copy

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_data import port_config

import jax

from tpuhar_torch import ood as pood
from tpuhar_torch.eval import ablation as pab
from tpuhar_torch.eval import zeroshot as pz
from tpuhar_torch.train.factory import build_crossmodal_task

torch.set_num_threads(2)


def _shrink(cfg):
    m = cfg.model
    m.imu_num_layers, m.imu_d_model, m.imu_nhead = 1, 32, 4
    m.classifier_hidden_dims, m.compute_dtype, m.head_norm = [16], "float32", "layer"
    m.video_d_model, m.projection_dim, m.projection_hidden_dim, m.fusion_heads = 32, 16, 32, 4
    cfg.data.video_frames_per_window = 4
    cfg.training.train_epochs = 1
    return cfg


@pytest.fixture(scope="module")
def prepared(synthetic_dataset, tmp_path_factory):
    from tpuhar.data.preprocess import Preprocessor
    from tpuhar.data.synthetic import make_synthetic_config

    jcfg = _shrink(make_synthetic_config(synthetic_dataset, tmp_path_factory.mktemp("zs") / "outputs"))
    dfs = {s: Preprocessor(jcfg).preprocess_split(s, save=True) for s in ("train", "val", "test")}
    return jcfg, dfs


# ---------------------------------------------------------------------------------
# zero-shot
# ---------------------------------------------------------------------------------
def test_zero_shot_matches_jax(prepared, tmp_path):
    from tpuhar.eval.zeroshot import compute_class_prototypes, zero_shot_evaluate
    from tpuhar.train.factory import build_crossmodal_task as jbuild

    jcfg, dfs = prepared
    cfg = port_config(jcfg)
    jtask = jbuild(jcfg, 1, jax.random.PRNGKey(0))
    variables = jax.device_get({"params": jtask.state.params, "batch_stats": jtask.state.batch_stats})
    task = build_crossmodal_task(cfg, 1, variables, device="cpu")
    want = compute_class_prototypes(jtask, dfs["train"], jcfg)
    got = pz.compute_class_prototypes(task, dfs["train"], cfg)
    assert got.dtype == np.float32 and got.shape == want.shape == (4, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    metrics = pz.zero_shot_evaluate(task, got, dfs["test"], cfg)
    assert metrics == zero_shot_evaluate(jtask, want, dfs["test"], jcfg)
    out = pz.run_zero_shot(task, dfs["train"], dfs["test"], cfg, save_path=tmp_path / "zeroshot_results.json")
    assert out == {"video_prototype_zeroshot": metrics}
    assert (tmp_path / "zeroshot_results.json").exists()


def test_zero_shot_imu_projection_needs_no_clip(prepared):
    """The IMU tower alone gives the IMU projection the full model gives beside the
    JAX package's un-normalized f32 zero clip, bit for bit; likewise the video side."""
    jcfg, _ = prepared
    cfg = port_config(jcfg)
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.models.crossmodal import CrossModalModel

    task = build_crossmodal_task(cfg, 1, init_params(cfg, torch.Generator().manual_seed(0), CrossModalModel), device="cpu")
    rng = np.random.default_rng(0)
    imu = torch.from_numpy(rng.standard_normal((3, 6, 250)).astype(np.float32))
    clip = torch.from_numpy(rng.standard_normal((3, 4, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        alone = task.model.forward_cast(imu, None)
        full = task.model.forward_cast(imu, torch.zeros(3, 4, 64, 64, 3))
        video_alone = task.model.forward_cast(None, clip)
        video_full = task.model.forward_cast(torch.zeros(3, 6, 250), clip)
    assert "video_proj" not in alone and "imu_proj" not in video_alone
    assert torch.equal(alone["imu_proj"], full["imu_proj"])
    assert torch.equal(video_alone["video_proj"], video_full["video_proj"])


# ---------------------------------------------------------------------------------
# leave-one-activity-out
# ---------------------------------------------------------------------------------
def test_leave_one_out_split_matches_jax(prepared, capsys):
    from tpuhar.ood import leave_one_out_split

    _, dfs = prepared
    for c in (0, 2):
        mine = pood.leave_one_out_split(dfs["train"], c)
        theirs = leave_one_out_split(dfs["train"], c)
        pd.testing.assert_frame_equal(mine[0], theirs[0])
        pd.testing.assert_frame_equal(mine[1], theirs[1])
        assert mine[2] == theirs[2]
        shared = {k: v for k, v in mine[2].items() if k != 3}  # a class the train split lacks
        m, t = pood.leave_one_out_split(dfs["test"], c, remap=shared), leave_one_out_split(dfs["test"], c, remap=shared)
        pd.testing.assert_frame_equal(m[0], t[0])
        pd.testing.assert_frame_equal(m[1], t[1])
        assert (m[0]["label"] < len(shared)).all()
    assert "dropping" in capsys.readouterr().out


def _loo_config(prepared, tmp_path, scores=("msp", "energy", "mahalanobis", "knn", "rmd")):
    cfg = port_config(prepared[0])
    cfg.paths.checkpoints_dir, cfg.paths.logs_dir = tmp_path / "ck", tmp_path / "logs"
    cfg.ood.scores, cfg.ood.knn_k = list(scores), 3
    return cfg


def test_loo_imu_rows_and_scores_match_jax_scorers(prepared, tmp_path):
    """Two held-out classes with the IMU classifier (the first and the last): five rows each; then the sweep again
    with ``reuse_checkpoints`` (each class scored from its ``last`` checkpoint, nothing
    trained: the same rows), and each row's AUROC and FPR recomputed from the JAX
    package's scorers on that checkpoint's embeddings."""
    from tpuhar import ood as jood
    from tpuhar.eval.metrics import auroc as jauroc
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.data.loader import BatchLoader
    from tpuhar_torch.eval.evaluator import Evaluator
    from tpuhar_torch.models.crossmodal import IMUClassifier
    from tpuhar_torch.train import checkpoint as ckpt
    from tpuhar_torch.train.factory import build_classification_task

    _, dfs = prepared
    cfg = _loo_config(prepared, tmp_path)
    ev = pood.OODEvaluator(cfg, torch.Generator().manual_seed(0), device="cpu")
    rows = ev.run_loo_experiments(dfs["train"], dfs["val"], dfs["test"], classes=[0, 3], verbose=False)
    assert list(rows.columns) == ["held_out_class", "score", "auroc", "fpr_at_95tpr", "id_accuracy", "n_id", "n_ood"]
    assert len(rows) == 10 and sorted(set(rows["score"])) == sorted(cfg.ood.scores)
    again = pood.OODEvaluator(cfg, torch.Generator().manual_seed(5), device="cpu").run_loo_experiments(
        dfs["train"], dfs["val"], dfs["test"], classes=[0, 3], verbose=False, reuse_checkpoints=True)
    pd.testing.assert_frame_equal(again, rows)
    agg = pood.OODEvaluator.aggregate(rows)
    assert list(agg.index) == sorted(cfg.ood.scores)

    for c in (0, 3):  # 3: the last class, whose OOD rows' label lies past the shrunk label space
        id_train, _, remap = pood.leave_one_out_split(dfs["train"], c)
        id_test, ood_test, _ = pood.leave_one_out_split(dfs["test"], c, remap=remap)
        loo = copy.deepcopy(cfg)
        loo.model.num_classes = len(remap)
        task = build_classification_task(loo, "finetune", 1, init_params(loo, torch.Generator(), IMUClassifier), device="cpu")
        task.state, _ = ckpt.restore_checkpoint(cfg.paths.checkpoints_dir / f"ood_loo_{c}" / "last", task.state)
        evaluate = lambda df: Evaluator(task, loo).evaluate(  # noqa: E731
            BatchLoader(df, loo, mode="classification", prefetch=0, device="cpu"))
        tr, idt, oodt = evaluate(id_train), evaluate(id_test), evaluate(ood_test)
        scorers = {
            "mahalanobis": jood.MahalanobisScorer.fit(tr["embeddings"], tr["labels"], loo.model.num_classes),
            "knn": jood.KNNScorer.fit(tr["embeddings"], k=3),
            "rmd": jood.RelativeMahalanobisScorer.fit(tr["embeddings"], tr["labels"], loo.model.num_classes),
        }
        want = {name: jood.compute_ood_scores(out["logits"], out["embeddings"], scores=list(cfg.ood.scores), **scorers)
                for name, out in (("id", idt), ("ood", oodt))}
        for _, row in rows[rows["held_out_class"] == c].iterrows():
            s = np.concatenate([np.asarray(want["id"][row["score"]]), np.asarray(want["ood"][row["score"]])])
            is_ood = np.r_[np.zeros(len(idt["logits"])), np.ones(len(oodt["logits"]))]
            assert row["auroc"] == pytest.approx(jauroc(s, is_ood), abs=1e-9), row["score"]
            assert row["fpr_at_95tpr"] == pytest.approx(jood.fpr_at_tpr(s, is_ood), abs=1e-9), row["score"]
            assert (row["n_id"], row["n_ood"]) == (len(idt["logits"]), len(oodt["logits"]))
            assert row["id_accuracy"] == idt["metrics"]["accuracy"]


def test_loo_fusion_and_refusals(prepared, tmp_path):
    _, dfs = prepared
    cfg = _loo_config(prepared, tmp_path, scores=("msp", "energy", "mahalanobis"))
    cfg.training.train_batch_size = 8
    rows = pood.OODEvaluator(cfg, device="cpu").run_loo_experiments(
        dfs["train"], dfs["val"], dfs["test"], classes=[1], verbose=False, model_kind="fusion")
    assert list(rows["score"]) == ["msp", "energy", "mahalanobis"]
    assert ((rows["auroc"] >= 0) & (rows["auroc"] <= 1)).all()
    with pytest.raises(ValueError, match="Unknown model_kind"):
        pood.OODEvaluator(cfg, device="cpu").run_loo_experiments(dfs["train"], dfs["val"], dfs["test"], model_kind="video")
    cfg.ood.scores = ["msp", "mahalanobs"]
    with pytest.raises(ValueError, match="Unknown ood.scores"):
        pood.OODEvaluator(cfg, device="cpu").run_loo_experiments(dfs["train"], dfs["val"], dfs["test"])


# ---------------------------------------------------------------------------------
# ablations
# ---------------------------------------------------------------------------------
def test_ablation_overrides_match_jax(prepared):
    from tpuhar.eval.ablation import DEFAULT_ABLATIONS, _apply_overrides

    jcfg, _ = prepared
    cfg = port_config(jcfg)
    assert pab.DEFAULT_ABLATIONS == DEFAULT_ABLATIONS
    for _, overrides in DEFAULT_ABLATIONS:
        mine, theirs = pab._apply_overrides(cfg, overrides), _apply_overrides(jcfg, overrides)
        for section in ("model", "data", "training"):
            assert vars(getattr(mine, section)) == vars(getattr(theirs, section))
        assert mine is not cfg and vars(cfg.data) == vars(jcfg.data)  # the base is left as it was


def test_two_variant_ablation(prepared, tmp_path):
    _, dfs = prepared
    cfg = _loo_config(prepared, tmp_path)
    out = pab.run_ablations(cfg, dfs["train"], dfs["val"], dfs["test"], ablations=pab.DEFAULT_ABLATIONS[:3:2],
                            verbose=False, device="cpu")
    assert list(out["config"]) == ["transformer_raw", "cnn_raw"]
    assert list(out.columns)[1:] == ["accuracy", "balanced_accuracy", "f1_macro", "f1_weighted", "precision_macro",
                                     "recall_macro"]
    assert (tmp_path / "ck" / "ablation_cnn_raw" / "last.pt").exists()
