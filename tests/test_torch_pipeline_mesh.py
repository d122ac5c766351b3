"""The port's pipeline over a data-parallel mesh (``cli.Pipeline`` in two processes, as
``torchrun --nproc_per_node=2 -m tpuhar_torch`` runs it) against one process, on the
CPU: the counterpart of ``tests/test_pipeline.py:172-186``.

Each of two spawned ranks sets torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) and runs ``Pipeline(cfg, device="cpu")``,
which joins the gloo group and builds a ``(2, 1)`` mesh; then ``run_preprocessing``
(rank 0 alone writes) and ``run_pretraining`` over the mesh (the ``tiny_cnn`` tower with
its train-mode BatchNorm, IMU dropout on, batch 8: 4 rows a rank). The best validation
loss is held to the one-process run's within 1e-4 (``tests/test_pipeline.py:186``'s
bound), the preprocessed manifests equal, and the trained parameters equal on the two
ranks bit for bit.

With ``training.model_axis_size=2`` the same two ranks build a ``(1, 2)`` mesh: the IMU
encoder's blocks split over the model axis (2 of its 4 heads and half its MLP a rank),
the batches whole on both. ``run_pretraining`` then ``run_classification("finetune")``,
which restores the best pretraining checkpoint's encoder (whole, as every checkpoint is)
and shards it again, then restores its own best checkpoint into the split state for the
test split. The best validation loss and the finetune's test logits are held to the
one-process run's within 1e-4; the checkpoints hold the whole tensors of the one-process
run's, name for name.
"""
import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from tpuhar_torch.cli import Pipeline
from tpuhar_torch.data.synthetic import make_synthetic_config

from test_torch_cli import shrink
from test_torch_mesh import free_port

torch.set_num_threads(2)

BEST_ATOL = 1e-4


def config(dataset: Path, root: Path):
    cfg = shrink(make_synthetic_config(dataset, root))
    cfg.training.pretrain_epochs, cfg.training.pretrain_batch_size = 1, 8
    return cfg


def _rank(rank: int, port: int, dataset: str, root: str, model_axis_size: int = 1) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                      LOCAL_RANK=str(rank))
    try:
        cfg = config(Path(dataset), Path(root))
        cfg.training.model_axis_size = model_axis_size
        pipe = Pipeline(cfg, device="cpu")
        mesh = dict(zip(pipe.mesh.mesh_dim_names, pipe.mesh.shape))
        pipe.run_preprocessing()
        trainer = pipe.run_pretraining()
        out = {"mesh": mesh, "best": trainer.best_metric, "history": trainer.history,
               "state": trainer.state.model.state_dict()}
        if model_axis_size > 1:
            out["split"] = sorted(trainer.state.model.tp_dims)
            pipe.run_classification("finetune")
        torch.save(out, Path(root) / f"rank{rank}.pt")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def single(synthetic_dataset, tmp_path_factory):
    """The one-process pipeline: preprocessing, pretraining, the finetune."""
    root = tmp_path_factory.mktemp("single")
    pipe = Pipeline(config(synthetic_dataset, root), device="cpu")
    assert pipe.mesh is None
    pipe.run_preprocessing()
    trainer = pipe.run_pretraining()
    pipe.run_classification("finetune")
    return root, trainer


def test_pipeline_over_a_mesh_matches_one_process(synthetic_dataset, tmp_path, single):
    torch.multiprocessing.start_processes(
        _rank, args=(free_port(), str(synthetic_dataset), str(tmp_path / "dp")), nprocs=2, start_method="spawn")
    r0, r1 = (torch.load(tmp_path / "dp" / f"rank{r}.pt", weights_only=False) for r in range(2))
    single_root, single = single

    assert r0["mesh"] == r1["mesh"] == {"data": 2, "model": 1}
    assert r0["best"] == r1["best"] and r0["history"] == r1["history"]
    for name, value in r0["state"].items():
        assert torch.equal(r1["state"][name], value), name
    assert len(single.history["train"]) == 1 and abs(r0["best"] - single.best_metric) < BEST_ATOL
    for split in ("train", "val", "test"):
        got, want = (pd.read_csv(root / "preprocessed" / f"{split}_metadata.csv") for root in (tmp_path / "dp", single_root))
        pd.testing.assert_frame_equal(got.drop(columns=[c for c in got if "path" in c]),
                                      want.drop(columns=[c for c in want if "path" in c]))
    assert (tmp_path / "dp" / "checkpoints" / "cross_modal" / "best_model.pt").exists()
    assert (tmp_path / "dp" / "checkpoints" / "final_model_params.pt").exists()


def test_pipeline_over_a_tp_mesh_matches_one_process(synthetic_dataset, tmp_path, single):
    torch.multiprocessing.start_processes(
        _rank, args=(free_port(), str(synthetic_dataset), str(tmp_path / "tp"), 2), nprocs=2, start_method="spawn")
    r0, r1 = (torch.load(tmp_path / "tp" / f"rank{r}.pt", weights_only=False) for r in range(2))
    single_root, single = single
    assert r0["mesh"] == r1["mesh"] == {"data": 1, "model": 2}
    assert r0["best"] == r1["best"] and r0["history"] == r1["history"]
    assert any("linear1" in n for n in r0["split"]) and r0["split"] == r1["split"]
    assert abs(r0["best"] - single.best_metric) < BEST_ATOL
    for name in r0["split"]:  # each rank holds its half of a split parameter
        assert r0["state"][name].numel() * 2 == single.state.model.state_dict()[name].numel(), name
    for path in ("cross_modal/best_model.pt", "classifier_finetune/best_model.pt", "final_model_params.pt"):
        got, want = (torch.load(root / "checkpoints" / path, weights_only=True) for root in (tmp_path / "tp", single_root))
        got, want = (d.get("model", d) for d in (got, want))
        assert {n: t.shape for n, t in got.items()} == {n: t.shape for n, t in want.items()}, path
    got, want = (np.load(root / "results" / "test_logits_finetune.npy") for root in (tmp_path / "tp", single_root))
    np.testing.assert_allclose(got, want, rtol=0, atol=BEST_ATOL)
