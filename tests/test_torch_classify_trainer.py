"""The port's classification loop and its checkpoints (``tpuhar_torch/train/loop.py:
ClassificationTrainer``, ``serving.InferenceEngine.from_checkpoint``), on the CPU.

``entry.classify_config``'s IMU classifier cut to test size (d=32, 1 layer, a LayerNorm
head 16 → 4 classes, f32) and the fusion classifier on ``videomae_tiny`` at 4 frames of
32², over tiny in-memory loaders of dict batches: ``fit``'s history and metric rows
carry the JAX trainer's keys (the JAX trainer runs the same stage beside it), early
stopping keeps the best epoch's ``best_model``, ``fit(resume=True)`` continues, and an
engine restored from a checkpoint predicts what an engine built from the trained
variables predicts, bit for bit (both run the same plain program on the same
parameters).
"""
import json

import numpy as np
import pytest
import torch

from tpuhar_torch.bridge import variables_to_numpy
from tpuhar_torch.config import PathConfig
from tpuhar_torch.entry import build_classification_task, build_fusion_task, classify_config, pretrain_config
from tpuhar_torch.serving import InferenceEngine
from tpuhar_torch.train import checkpoint as ckpt
from tpuhar_torch.train.loop import ClassificationTrainer
from tpuhar_torch.train.steps import make_crossmodal_steps

torch.set_num_threads(2)

B, CLASSES = 8, 4


def _config(tmp_path, epochs: int = 2):
    cfg = classify_config()
    m = cfg.model
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 32, 4, 1
    m.classifier_hidden_dims, m.num_classes = [16], CLASSES
    m.compute_dtype = "float32"
    cfg.training.train_epochs = epochs
    cfg.paths = PathConfig(base_output=tmp_path / "out")
    return cfg


def _fusion_config(tmp_path):
    cfg = pretrain_config()
    m = cfg.model
    m.video_backbone, m.video_d_model = "videomae_tiny", 64
    m.imu_d_model, m.imu_nhead, m.imu_num_layers, m.fusion_heads = 32, 4, 1, 4
    m.classifier_hidden_dims, m.num_classes = [16], CLASSES
    m.compute_dtype = "float32"
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 4
    cfg.training.train_epochs = 1
    cfg.paths = PathConfig(base_output=tmp_path / "out")
    return cfg


def _batches(n: int, seed: int, *, video: bool = False, n_valid=None, tensors: bool = True):
    """Seeded batches whose IMU windows carry their label as an offset (so that the
    classifier has something to learn); the last ``B - n_valid`` rows zero-padded."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = rng.integers(0, CLASSES, (B,))
        imu = rng.standard_normal((B, 6, 250)).astype(np.float32) + label[:, None, None].astype(np.float32)
        batch = {"imu": imu, "label": label.astype(np.int32), "n_valid": B if n_valid is None else n_valid}
        if video:
            batch["video"] = rng.integers(0, 256, (B, 4, 32, 32, 3), dtype=np.uint8)
        if n_valid is not None:
            for key in ("imu", "video"):
                if key in batch:
                    batch[key][n_valid:] = 0
        if tensors:
            batch = {k: torch.from_numpy(v).long() if k == "label" else (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                     for k, v in batch.items()}
        out.append(batch)
    return out


def _trainer(cfg, task, save_dir, mode="finetune"):
    trainer = ClassificationTrainer(cfg, task.state, task.train_step, task.eval_step, save_dir,
                                    torch.Generator().manual_seed(0), mode)
    trainer.verbose = False
    return trainer


def test_fit_history_and_metric_rows_carry_the_jax_trainers_keys(tmp_path):
    """Two epochs of the finetune in both packages on the same batches: the history's
    entries, the metric stream's JSONL rows and CSV header, ``training_history.json`` and
    the checkpoint sidecars have the same keys; ``last`` and ``best_model`` are written."""
    import jax
    import jax.numpy as jnp

    from tpuhar.config import Config as JConfig
    from tpuhar.config import PathConfig as JPathConfig
    from tpuhar.models.crossmodal import IMUClassifier as JIMUClassifier
    from tpuhar.train.loop import ClassificationTrainer as JClassificationTrainer
    from tpuhar.train.optim import make_classification_optimizer
    from tpuhar.train.steps import init_state, make_classification_steps

    cfg = _config(tmp_path)
    task = build_classification_task(cfg, "finetune", device="cpu", steps_per_epoch=2)
    trainer = _trainer(cfg, task, tmp_path / "port" / "classifier_finetune")
    trainer.fit(_batches(2, 0), _batches(1, 1, n_valid=5))

    jcfg = JConfig()
    for section in ("model", "training", "data"):
        for key, value in vars(getattr(cfg, section)).items():
            setattr(getattr(jcfg, section), key, value)
    jcfg.paths = JPathConfig(base_output=tmp_path / "jax_out")
    jmodel = JIMUClassifier(jcfg)
    key = jax.random.PRNGKey(0)
    example = jnp.zeros((B, 6, 250))
    tx = make_classification_optimizer(jcfg, 2, "finetune", jmodel.init(key, example)["params"])
    jtrain, jpredict = make_classification_steps(jmodel, jcfg)
    jtrainer = JClassificationTrainer(jcfg, init_state(jmodel, tx, key, example), jtrain, jpredict,
                                      tmp_path / "jax" / "classifier_finetune", key, "finetune")
    jtrainer.verbose = False
    jtrainer.fit(_batches(2, 0, tensors=False), _batches(1, 1, n_valid=5, tensors=False))

    assert len(trainer.history["train"]) == len(jtrainer.history["train"]) == 2
    for split in ("train", "val"):
        for ours, theirs in zip(trainer.history[split], jtrainer.history[split]):
            assert list(ours) == list(theirs), split
            assert all(np.isfinite(v) for v in ours.values())
    rows = trainer.metrics_logger.read()
    jrows = jtrainer.metrics_logger.read()
    assert [list(r) for r in rows] == [list(r) for r in jrows] and len(rows) == 2
    assert [(r["step"], r["stage"]) for r in rows] == [(0, "classify_finetune"), (1, "classify_finetune")]
    assert trainer.metrics_logger.jsonl_path == tmp_path / "out" / "logs" / "classifier_finetune.jsonl"
    header = trainer.metrics_logger.csv_path.read_text().splitlines()[0]
    assert header == jtrainer.metrics_logger.csv_path.read_text().splitlines()[0]
    ours = json.loads((trainer.save_dir / "training_history.json").read_text())
    assert ours == json.loads(json.dumps(trainer.history))
    for name in ("last", "best_model"):
        assert ckpt.checkpoint_exists(trainer.save_dir / name)
        sidecar = json.loads((trainer.save_dir / name).with_suffix(".json").read_text())
        assert list(sidecar) == list(json.loads((jtrainer.save_dir / name).with_suffix(".json").read_text()))
    assert trainer.best_metric == max(v["balanced_accuracy"] for v in trainer.history["val"])


def test_early_stopping_keeps_the_best_epoch(tmp_path):
    """``patience`` 1 and a validation that scores every row right at epoch 0 and wrong
    after it: the fit stops at epoch 1 of 5; ``best_model`` holds epoch 0's parameters,
    bit for bit, and ``last`` epoch 1's."""
    cfg = _config(tmp_path, epochs=5)
    cfg.training.patience = 1
    task = build_classification_task(cfg, "finetune", device="cpu", steps_per_epoch=2)
    snapshots = []

    def predict_step(state, batch):  # one validation batch an epoch
        out = task.eval_step(state, batch)
        if not snapshots:  # epoch 0: the state that best_model will hold
            snapshots.append({k: v.clone() for k, v in state.model.state_dict().items()})
            out["preds"] = batch["label"]
        else:
            out["preds"] = (batch["label"] + 1) % CLASSES
        return out

    trainer = ClassificationTrainer(cfg, task.state, task.train_step, predict_step, tmp_path / "ckpt",
                                    torch.Generator().manual_seed(0), "finetune")
    trainer.verbose = False
    trainer.fit(_batches(2, 0), _batches(1, 1))
    assert trainer.current_epoch == 1 and len(trainer.history["val"]) == 2
    assert [v["balanced_accuracy"] for v in trainer.history["val"]] == [100.0, 0.0]
    best = json.loads((tmp_path / "ckpt" / "best_model.json").read_text())
    assert best["epoch"] == 0 and best["best_balanced_accuracy"] == 100.0
    assert json.loads((tmp_path / "ckpt" / "last.json").read_text())["epoch"] == 1
    restored = build_classification_task(cfg, "finetune", device="cpu", seed=1, steps_per_epoch=2)
    ckpt.restore_checkpoint(tmp_path / "ckpt" / "best_model", restored.state)
    first = snapshots[0]
    assert all(torch.equal(t, first[k]) for k, t in restored.model.state_dict().items())
    assert not all(torch.equal(t, first[k]) for k, t in task.model.state_dict().items())


def test_resume_continues_from_the_next_epoch(tmp_path):
    cfg = _config(tmp_path)
    task = build_classification_task(cfg, "finetune", device="cpu", steps_per_epoch=2)
    _trainer(cfg, task, tmp_path / "ckpt").fit(_batches(2, 0), _batches(1, 1))
    cfg.training.train_epochs = 3
    again = build_classification_task(cfg, "finetune", device="cpu", steps_per_epoch=2)
    trainer = _trainer(cfg, again, tmp_path / "ckpt")
    trainer.fit(_batches(2, 0), _batches(1, 1), resume=True)
    assert trainer.current_epoch == 2 and len(trainer.history["val"]) == 3
    assert again.state.step == 6 and again.state.optimizer.count == 6


@pytest.mark.parametrize("mode", ["linear_probe", "finetune"])
def test_imu_engine_from_checkpoint(tmp_path, mode):
    """The IMU-only engine restored from ``last`` (a probe's checkpoint too, whose
    optimizer state is not a finetune's) predicts as an engine of the trained
    variables."""
    cfg = _config(tmp_path, epochs=1)
    task = build_classification_task(cfg, mode, device="cpu", steps_per_epoch=2)
    _trainer(cfg, task, tmp_path / "ckpt", mode).fit(_batches(2, 0), _batches(1, 1))
    engine = InferenceEngine.from_checkpoint(cfg, tmp_path / "ckpt" / "last", imu_only=True, device="cpu",
                                             batch_sizes=[4, 8])
    reference = InferenceEngine(cfg, variables_to_numpy(task.model), imu_only=True, device="cpu", batch_sizes=[4, 8])
    imu = np.random.default_rng(5).normal(0, 8000, (6, 250, 6)).astype(np.float32)
    got, want = engine.predict(imu), reference.predict(imu)
    assert got.keys() == want.keys() and got["logits"].shape == (6, CLASSES)
    for key, value in want.items():
        assert np.array_equal(got[key], value), key


def test_fusion_engine_from_checkpoint(tmp_path):
    """The fusion classifier trained one epoch, its ``best_model`` served through
    ``from_checkpoint``, against an engine of the trained variables."""
    cfg = _fusion_config(tmp_path)
    task = build_fusion_task(cfg, device="cpu", steps_per_epoch=1)
    trainer = _trainer(cfg, task, tmp_path / "ckpt")
    trainer.fit(_batches(1, 0, video=True), _batches(1, 1, video=True, n_valid=6))
    engine = InferenceEngine.from_checkpoint(cfg, tmp_path / "ckpt" / "best_model", device="cpu", batch_sizes=[4])
    reference = InferenceEngine(cfg, variables_to_numpy(task.model), device="cpu", batch_sizes=[4])
    rng = np.random.default_rng(6)
    imu = rng.normal(0, 8000, (3, 250, 6)).astype(np.float32)
    clip = rng.integers(0, 256, (3, 4, 32, 32, 3), dtype=np.uint8)
    got, want = engine.predict(imu, clip), reference.predict(imu, clip)
    assert got.keys() == want.keys() and got["embeddings"].shape == (3, 2 * cfg.model.imu_d_model)
    for key, value in want.items():
        assert np.array_equal(got[key], value), key


def test_from_checkpoint_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        InferenceEngine.from_checkpoint(_config(tmp_path), tmp_path / "none", imu_only=True)


@pytest.mark.parametrize("precision", ["bfloat16", "float32", "default"])
def test_steps_leave_torch_state_as_it_was(tmp_path, precision):
    """A train step and a predict step set the configured matmul precision only inside
    themselves: PyTorch's f32 matmul precision, cuDNN's TF32 flag, the thread count, the
    default dtype and grad mode are as they were after them."""
    cfg = _config(tmp_path)
    cfg.training.pretrain_matmul_precision = precision
    task = build_classification_task(cfg, "finetune", device="cpu", steps_per_epoch=2)

    def state():
        return (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32, torch.get_num_threads(),
                torch.get_default_dtype(), torch.is_grad_enabled())

    before = state()
    batch = _batches(1, 0)[0]
    task.train_step(task.state, batch, None)
    task.eval_step(task.state, batch)
    assert state() == before


def test_augmented_steps(tmp_path):
    """With ``use_augmentation`` the train step augments the IMU windows from its
    generator: the same seed gives the same update, and it differs from the update
    without augmentation; the pretraining steps take the option too."""
    cfg = _config(tmp_path)
    batch = _batches(1, 0)[0]
    params = {}
    for augment in (True, True, False):
        cfg.data.use_augmentation = augment
        task = build_classification_task(cfg, "finetune", device="cpu", steps_per_epoch=2)
        task.train_step(task.state, batch, torch.Generator().manual_seed(3))
        params.setdefault(augment, []).append(torch.cat([p.detach().flatten() for p in task.model.parameters()]))
    assert torch.equal(params[True][0], params[True][1])
    assert not torch.equal(params[True][0], params[False][0])
    pcfg = pretrain_config()
    pcfg.data.use_augmentation = True
    make_crossmodal_steps(pcfg)  # no longer refused


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


def test_pretrained_encoder_is_grafted(tmp_path):
    """``encoder_params`` replaces the classifier's ``imu_encoder`` with a pretraining
    state's, as ``tpuhar/train/factory.py: _graft`` does, in the IMU and the fusion
    classifier; without it the encoder is the classifier's own draw."""
    from tpuhar_torch.entry import build_pretrain_task

    cfg = _fusion_config(tmp_path)
    pretrained = variables_to_numpy(build_pretrain_task(cfg, device="cpu", seed=3, steps_per_epoch=1).model)
    encoder = dict(_leaves(pretrained["params"]["imu_encoder"]))
    builds = {
        "imu": lambda **kw: build_classification_task(cfg, "linear_probe", device="cpu", seed=5, steps_per_epoch=1, **kw),
        "fusion": lambda **kw: build_fusion_task(cfg, device="cpu", seed=5, steps_per_epoch=1, **kw),
    }
    for name, build in builds.items():
        grafted = dict(_leaves(variables_to_numpy(build(encoder_params=pretrained["params"]["imu_encoder"]).model)["params"]["imu_encoder"]))
        own = dict(_leaves(variables_to_numpy(build().model)["params"]["imu_encoder"]))
        assert grafted.keys() == encoder.keys() == own.keys(), name
        assert all(np.array_equal(grafted[k], v) for k, v in encoder.items()), name
        assert not np.array_equal(own["cls_token"], encoder["cls_token"]), name
