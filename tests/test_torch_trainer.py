"""The port's pretraining loop (``tpuhar_torch/train/{loop,checkpoint,factory}.py``):
the counterparts of ``tests/test_train.py``'s early-stopping, checkpoint round-trip and
resume tests, on ``entry.pretrain_config``'s model cut to test size (``videomae_tiny``
on 4 frames of 32², the IMU encoder at d=32 with dropout 0.1) and a tiny in-memory
loader of dict batches, on the CPU.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuhar_torch.bridge import init_params, variables_to_numpy
from tpuhar_torch.config import PathConfig
from tpuhar_torch.entry import build_pretrain_task, pretrain_config
from tpuhar_torch.models.crossmodal import CrossModalModel
from tpuhar_torch.train import checkpoint as ckpt
from tpuhar_torch.train.factory import build_crossmodal_task
from tpuhar_torch.train.loop import CrossModalTrainer, EarlyStopper

torch.set_num_threads(2)


def _config(epochs: int = 2):
    cfg = pretrain_config()
    m = cfg.model
    m.video_backbone, m.video_d_model = "videomae_tiny", 64
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 32, 4, 1
    m.projection_dim, m.projection_hidden_dim = 16, 32
    m.compute_dtype = "float32"
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 4
    cfg.training.pretrain_epochs = epochs
    cfg.training.pretrain_warmup_epochs = 1
    cfg.training.save_every = 1
    return cfg


class Loader:
    """Seeded dict batches in memory; records the epochs it was set to."""

    def __init__(self, n: int, batch: int, seed: int, n_valid=None):
        rng = np.random.default_rng(seed)
        self.batches = []
        for _ in range(n):
            b = {"imu": torch.from_numpy(rng.standard_normal((batch, 6, 250)).astype(np.float32)),
                 "video": torch.from_numpy(rng.integers(0, 256, (batch, 4, 32, 32, 3), dtype=np.uint8))}
            if n_valid is not None:
                b["n_valid"] = n_valid
            self.batches.append(b)
        self.epochs = []

    def set_epoch(self, epoch: int) -> None:
        self.epochs.append(epoch)

    def __iter__(self):
        return iter(self.batches)


def _trainer(cfg, save_dir, params):
    cfg.paths = PathConfig(base_output=Path(save_dir))  # the metric stream: <save_dir>/logs
    task = build_pretrain_task(cfg, device="cpu", params=params, steps_per_epoch=2)
    trainer = CrossModalTrainer(cfg, task.state, task.train_step, task.eval_step, save_dir,
                                generator=torch.Generator().manual_seed(0))
    trainer.verbose = False
    return trainer


def test_early_stopper_min_mode():
    s = EarlyStopper(patience=2, mode="min", min_delta=0.01)
    assert s.update(1.0)
    assert not s.update(0.995)  # within min_delta: not an improvement
    assert s.counter == 1
    assert s.update(0.9)
    assert s.counter == 0
    s.update(0.91)
    s.update(0.92)
    assert s.should_stop


def test_early_stopper_max_mode():
    s = EarlyStopper(patience=1, mode="max")
    s.update(50.0)
    assert not s.update(50.0)
    assert s.should_stop


def test_init_params_of_the_crossmodal_model():
    cfg = _config()
    tree = init_params(cfg, torch.Generator().manual_seed(0), CrossModalModel)
    p, stats = tree["params"], tree["batch_stats"]
    assert p["temperature"].shape == () and p["temperature"] == np.float32(math.log(10.0))
    assert p["bias"] == np.float32(-10.0)
    for head in ("imu_proj", "video_proj"):
        assert np.all(p[head]["bn"]["scale"] == 1) and np.all(p[head]["bn"]["bias"] == 0)
        assert np.all(stats[head]["bn"]["mean"] == 0) and np.all(stats[head]["bn"]["var"] == 1)
        assert p[head]["fc1"]["kernel"].shape == ((32 if head == "imu_proj" else 64), 32)
    # the tree loads into the model and comes back unchanged
    task = build_pretrain_task(cfg, device="cpu", params=tree, steps_per_epoch=1)
    back = variables_to_numpy(task.model)
    assert back["params"]["temperature"] == p["temperature"]
    np.testing.assert_array_equal(back["params"]["imu_encoder"]["block0"]["self_attn"]["query"]["kernel"],
                                  p["imu_encoder"]["block0"]["self_attn"]["query"]["kernel"])


def test_weights_io_is_refused():
    cfg = _config()
    cfg.model.video_weights_path = "videomae.safetensors"
    with pytest.raises(NotImplementedError, match="weights"):
        build_crossmodal_task(cfg, 1, {}, device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    cfg = _config()
    params = init_params(cfg, torch.Generator().manual_seed(0), CrossModalModel)
    task = build_pretrain_task(cfg, device="cpu", params=params, steps_per_epoch=2)
    batch = Loader(1, 4, seed=1).batches[0]
    state, out = task.train_step(task.state, batch, torch.Generator().manual_seed(0))
    assert math.isfinite(out["loss"].item())
    ckpt.save_checkpoint(tmp_path / "ck", state, extra={"epoch": 3, "note": "x"})
    fresh = build_pretrain_task(cfg, device="cpu", params=params, steps_per_epoch=2)
    restored, extra = ckpt.restore_checkpoint(tmp_path / "ck", fresh.state)
    assert extra == {"epoch": 3, "note": "x"}
    assert restored.step == state.step == 1 and restored.optimizer.count == 1
    trained = state.model.state_dict()
    for name, t in restored.model.state_dict().items():
        assert torch.equal(t, trained[name]), name
    for a, b in zip(restored.optimizer.mu + restored.optimizer.nu, state.optimizer.mu + state.optimizer.nu):
        assert torch.equal(a, b)


def test_trainer_resume_continues_from_epoch(tmp_path):
    """fit → interrupt → fit(resume=True) continues from the next epoch with its history."""
    params = init_params(_config(), torch.Generator().manual_seed(0), CrossModalModel)
    train, val = Loader(2, 4, seed=2), Loader(1, 4, seed=3, n_valid=3)
    t1 = _trainer(_config(epochs=2), tmp_path, params)
    t1.fit(train, val)  # epochs 0 and 1
    assert train.epochs == [0, 1] and len(t1.history["val"]) == 2
    assert all(math.isfinite(x) for x in t1.history["train"] + t1.history["val"])
    assert t1.best_metric == min(t1.history["val"])
    for name in ("last", "best_model", "checkpoint_epoch_0", "checkpoint_epoch_1"):
        assert ckpt.checkpoint_exists(tmp_path / name), name
    assert json.loads((tmp_path / "last.json").read_text())["epoch"] == 1
    assert json.loads((tmp_path / "training_history.json").read_text()) == t1.history

    t2 = _trainer(_config(epochs=4), tmp_path, params)
    t2.fit(train, val, resume=True)
    assert t2.current_epoch == 3  # resumed at 2, ran 2 and 3
    assert len(t2.history["val"]) == 4  # history carried over and extended
    assert t2.history["train"][:2] == t1.history["train"]
    assert t2.state.step == t2.state.optimizer.count == 8


def test_fit_writes_the_pretrain_metric_rows(tmp_path):
    """One row an epoch in ``<paths.logs_dir>/<save_dir name>.jsonl`` and ``.csv``, with the
    JAX trainer's keys: step, time, stage "pretrain", train_loss, val_loss."""
    params = init_params(_config(), torch.Generator().manual_seed(0), CrossModalModel)
    trainer = _trainer(_config(epochs=2), tmp_path / "pretrain", params)
    trainer.fit(Loader(1, 4, seed=2), Loader(1, 4, seed=3))
    rows = trainer.metrics_logger.read()
    assert trainer.metrics_logger.jsonl_path == tmp_path / "pretrain" / "logs" / "pretrain.jsonl"
    assert [list(r) for r in rows] == [["step", "time", "stage", "train_loss", "val_loss"]] * 2
    assert [(r["step"], r["stage"], r["train_loss"], r["val_loss"]) for r in rows] == [
        (i, "pretrain", trainer.history["train"][i], trainer.history["val"][i]) for i in range(2)
    ]
    assert trainer.metrics_logger.csv_path.read_text().splitlines()[0] == "step,time,stage,train_loss,val_loss"
