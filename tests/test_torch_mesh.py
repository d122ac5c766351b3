"""The port's mesh and process group (``tpuhar_torch/parallel/``) on the CPU, against the
JAX package's rules (``tpuhar/parallel/mesh.py``, ``distributed.py``).

- ``maybe_mesh``: None in one process, with ``data_parallel`` off, and in a world of
  one; ``model_axis_size=2`` in a world of one raises the ``ValueError`` that JAX's
  raises on one device; a mesh ``(world, 1)`` in a world of two, and ``(1, 2)`` there
  with ``model_axis_size=2`` (rank ``k`` at model index ``k``).
- ``create_mesh``: dims ``("data", "model")``, shape ``(world // tp, tp)``; a world
  that does not divide raises, as JAX's does.
- ``shard_batch``: the rows of each rank are the JAX shard on the matching device of a
  ``(2, 1)`` mesh, bit for bit; an array whose rows do not divide, a scalar and a list
  stay whole (JAX replicates them); a placed batch is placed once.
- In two spawned processes (gloo): ``initialize_distributed`` from torchrun's
  environment, ``local_batch_slice``, ``shard_state`` (rank 1's perturbed parameters,
  moments and counts become rank 0's) and a checkpoint written by rank 0 alone.
"""
import os
import socket
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpuhar_torch.config import Config
from tpuhar_torch.parallel import distributed as D
from tpuhar_torch.parallel import mesh as M
from tpuhar_torch.parallel.scope import DataShard

torch.set_num_threads(2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture()
def world1():
    """A gloo group of one process, destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_maybe_mesh_follows_jax(monkeypatch):
    from tpuhar.parallel.mesh import maybe_mesh as jax_maybe_mesh
    import jax

    cfg = Config()
    assert M.maybe_mesh(cfg) is None and M.maybe_mesh() is None  # one process, no group
    assert jax_maybe_mesh(cfg, jax.devices()[:1]) is None  # one device
    cfg.training.data_parallel = False
    assert M.maybe_mesh(cfg) is None and jax_maybe_mesh(cfg) is None
    cfg.training.data_parallel, cfg.training.model_axis_size = True, 2
    with pytest.raises(ValueError, match="model_axis_size=2 needs at least that many devices; have 1"):
        M.maybe_mesh(cfg)
    with pytest.raises(ValueError, match="model_axis_size=2 needs at least that many devices; have 1"):
        jax_maybe_mesh(cfg, jax.devices()[:1])
    assert D.initialize_distributed(device="cpu") is False  # no torchrun environment: one process
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    assert D.initialize_distributed(device="cpu") is False and not dist.is_initialized()
    assert D.local_batch_slice(8) == slice(0, 8)


def test_mesh_in_a_world_of_one(world1):
    from tpuhar.parallel.mesh import create_mesh as jax_create_mesh
    import jax

    cfg = Config()
    assert M.maybe_mesh(cfg) is None  # JAX's: None on one device
    mesh = M.create_mesh()
    theirs = jax_create_mesh(jax.devices()[:1])
    assert tuple(mesh.mesh_dim_names) == tuple(theirs.axis_names) == ("data", "model")
    assert tuple(mesh.shape) == tuple(theirs.devices.shape) == (1, 1)
    with pytest.raises(ValueError, match="not divisible"):
        M.create_mesh(model_axis_size=2)
    with pytest.raises(ValueError, match="not divisible"):
        jax_create_mesh(jax.devices()[:1], model_axis_size=2)
    assert M.data_shard(mesh) == DataShard(0, 1, mesh.get_group("data"))
    assert D.initialize_distributed(device="cpu") is False  # a group of one is kept


class _Mesh:
    """A stand-in for rank ``rank`` of a ``(2, 1)`` mesh: what ``data_shard`` reads."""

    mesh_dim_names = ("data", "model")

    def __init__(self, rank):
        self.rank = rank

    def get_local_rank(self, axis):
        return self.rank

    def __getitem__(self, axis):
        return type("Dim", (), {"size": lambda self: 2})()

    def get_group(self, axis):
        return None


def test_shard_batch_rules_match_jax():
    import jax
    from jax.sharding import Mesh

    from tpuhar.parallel.mesh import shard_batch as jax_shard_batch

    rng = np.random.default_rng(0)
    batch = {
        "imu": rng.standard_normal((8, 6, 250)).astype(np.float32),
        "label": rng.integers(0, 4, 8).astype(np.int32),
        "odd": rng.standard_normal((3, 2)).astype(np.float32),
        "n_valid": np.int32(5),
    }
    theirs = jax_shard_batch(batch, Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model")))
    for rank in range(2):
        for kind in (np.asarray, torch.from_numpy):
            given = {k: (kind(v) if np.ndim(v) else v) for k, v in batch.items()}
            given["names"] = ["a", "b"]
            mine = M.shard_batch(given, _Mesh(rank))
            assert mine.shard == DataShard(rank, 2, None)
            assert M.shard_batch(mine, _Mesh(1 - rank)) is mine  # placed once
            for key, value in theirs.items():
                shard = value.addressable_shards[rank].data
                assert (mine[key] is given[key]) == (shard.shape == value.shape), key  # whole where JAX replicates
                np.testing.assert_array_equal(np.asarray(mine[key]), np.asarray(shard), err_msg=key)
            assert mine["names"] is given["names"]
    whole = M.shard_batch({"odd": batch["odd"], "n_valid": 5}, _Mesh(0))
    assert whole.shard is None and whole["odd"] is batch["odd"]  # runs whole on every rank


def _rank(rank: int, port: int, out_dir: str) -> None:
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.models.crossmodal import IMUClassifier
    from tpuhar_torch.train import checkpoint as ckpt
    from tpuhar_torch.train.factory import build_classification_task

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                      LOCAL_RANK=str(rank))
    result = {"initialized": D.initialize_distributed(device="cpu")}
    try:
        cfg = Config()
        cfg.model.imu_d_model, cfg.model.imu_nhead, cfg.model.imu_num_layers, cfg.model.num_classes = 32, 4, 1, 4
        mesh = M.maybe_mesh(cfg)
        shard = M.data_shard(mesh)
        result.update(shape=tuple(mesh.shape), dims=tuple(mesh.mesh_dim_names), slice=D.local_batch_slice(8),
                      shard=(shard.rank, shard.size))
        cfg.training.model_axis_size = 2
        tp = M.maybe_mesh(cfg)
        result["tp"] = (tuple(tp.shape), tuple(tp.mesh_dim_names), M.model_shard(tp).rank, M.data_shard(tp).size)
        params = init_params(cfg, torch.Generator().manual_seed(rank), IMUClassifier)  # unequal on purpose
        task = build_classification_task(cfg, "finetune", 1, params, device="cpu")
        opt = task.state.optimizer
        opt.count, task.state.step = 3 + rank, 5 + rank
        for t in opt.mu:
            t.fill_(rank + 1.0)
        M.shard_state(task.state, mesh)
        result["state"] = {k: v.clone() for k, v in task.model.state_dict().items()}
        result["moments"] = [t.clone() for t in opt.mu]
        result["counts"] = (opt.count, task.state.step)
        path = Path(out_dir) / "ckpt" / "last"
        ckpt.save_checkpoint(path, task.state, extra={"rank": rank}, mesh=mesh)
        result["written"] = path.with_suffix(".pt").exists()
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_world2_group_mesh_state_and_checkpoint(tmp_path):
    import json

    torch.multiprocessing.start_processes(_rank, args=(free_port(), str(tmp_path)), nprocs=2, start_method="spawn")
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2))
    for rank, r in enumerate((r0, r1)):
        assert r["initialized"] is True and r["shape"] == (2, 1) and r["dims"] == ("data", "model")
        assert r["slice"] == slice(4 * rank, 4 * rank + 4) and r["shard"] == (rank, 2)
        assert r["tp"] == ((1, 2), ("data", "model"), rank, 1) and r["written"]
    assert r1["counts"] == r0["counts"] == (3, 5)
    for name, value in r0["state"].items():
        assert torch.equal(r1["state"][name], value), name
    assert all(torch.equal(a, b) and (a == 1.0).all() for a, b in zip(r0["moments"], r1["moments"]))
    assert json.loads((tmp_path / "ckpt" / "last.json").read_text()) == {"rank": 0}  # rank 0 wrote it
