"""Data-parallel steps of the port (``parallel/``, ``train/steps.py`` with ``mesh``) on
the CPU: two processes on gloo against one process on the global batch, and against the
JAX package's steps on a ``(2, 1)`` mesh of the conftest's fake devices.

One spawn of two ranks (``torch.multiprocessing``, gloo on a free port) runs every case
on a global batch of 8 (4 rows a rank), from the same parameters (``bridge.
init_params``) and the same dropout generator on both ranks:

- ``pretrain``: the cross-modal step (``videomae_tiny`` cut to test size, BatchNorm
  projection heads, SigLIP) with IMU dropout 0.1 and augmentation (time warp and
  jitter) on; then its eval step on a zero-padded batch with ``n_valid`` 5 (odd: 4 valid
  rows on rank 0, 1 on rank 1);
- ``classify``: the IMU classifier's finetune step with dropout and augmentation on;
  its predict step with ``n_valid`` 5;
- ``pretrain_plain`` and ``classify_plain``: the same with dropout and augmentation off;
- ``tower``: the video classifier on the ``tiny_cnn`` tower, whose train-mode
  BatchNorm takes the global batch's moments; its predict step with ``n_valid`` 5.

Each rank's losses must equal the other's bit for bit (a global value on every rank).
Against the one-process step on the global batch (f32 on both sides; the order of the
sums differs: each rank reduces its rows, then the ranks are summed):

- losses and eval sums: 1e-5 relative;
- the gradients after the all-reduce, leaf by leaf: ``|world 2 − world 1| ≤ 1e-4 ·
  max|leaf| + 1e-5 · max|any gradient|``, as ``tests/test_torch_pretrain_step.py``
  holds the port to JAX (the second term is the rounding floor of gradients that vanish
  in exact arithmetic);
- BatchNorm running statistics after the step: 1e-5 absolute;
- predictions (gathered) equal; ``valid`` is the global mask.

With dropout off, the losses against the JAX package's steps on a ``(2, 1)`` mesh: 1e-5
(the bound of ``tests/test_sharding.py:154``).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuhar_torch.bridge import grads_to_numpy, init_params
from tpuhar_torch.config import Config
from tpuhar_torch.models.crossmodal import CrossModalModel, IMUClassifier, VideoClassifier

from test_torch_mesh import free_port

torch.set_num_threads(2)

WORLD, B, N_VALID = 2, 8, 5
CASES = ("pretrain", "classify", "pretrain_plain", "classify_plain", "tower")
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR, STATS_ATOL, JAX_ATOL = 1e-5, 1e-4, 1e-5, 1e-5, 1e-5


def config(case: str) -> Config:
    cfg = Config()
    m, d = cfg.model, cfg.data
    m.compute_dtype, m.num_classes = "float32", 4
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 32, 4, 2
    m.projection_dim, m.projection_hidden_dim = 16, 32
    m.video_backbone, m.video_d_model = ("tiny_cnn", 64) if case == "tower" else ("videomae_tiny", 64)
    m.use_flash_attention, m.flash_kernel, m.video_pretrained = True, "library", False
    m.head_norm = "batch" if case.startswith("pretrain") else "layer"
    m.classifier_hidden_dims = [32]
    plain = case.endswith("plain") or case == "tower"
    m.imu_dropout = 0.0 if plain else 0.1
    m.classifier_dropout = 0.0 if plain else 0.3
    d.use_augmentation = not plain
    d.video_resize, d.video_frames_per_window = (32, 32), 4
    return cfg


def model_cls(case: str):
    return {"pretrain": CrossModalModel, "classify": IMUClassifier, "tower": VideoClassifier}[case.split("_")[0]]


def build_task(case: str, mesh=None):
    from tpuhar_torch.train import factory

    cfg = config(case)
    params = init_params(cfg, torch.Generator().manual_seed(0), model_cls(case))
    kind = case.split("_")[0]
    if kind == "pretrain":
        return factory.build_crossmodal_task(cfg, 4, params, device="cpu", mesh=mesh)
    if kind == "classify":
        return factory.build_classification_task(cfg, "finetune", 4, params, device="cpu", mesh=mesh)
    return factory.build_video_task(cfg, 4, params, device="cpu", mesh=mesh)


def batch(case: str, seed: int, n_valid=None) -> dict:
    rng = np.random.default_rng(seed)
    out = {"imu": rng.standard_normal((B, 6, 250)).astype(np.float32),
           "video": rng.integers(0, 256, (B, 4, 32, 32, 3), dtype=np.uint8),
           "label": rng.integers(0, 4, B).astype(np.int64)}
    if n_valid is not None:
        for k in ("imu", "video"):
            out[k][n_valid:] = 0
    t = {k: torch.from_numpy(v) for k, v in out.items()}
    if n_valid is not None:
        t["n_valid"] = n_valid
    return t


def run_case(case: str, mesh=None, *, presharded: bool = False) -> dict:
    """One train step and one eval step of ``case``: losses, gradients (after the
    all-reduce), BatchNorm statistics and the eval outputs, as numpy."""
    task = build_task(case, mesh)
    train = batch(case, 1)
    if presharded:
        from tpuhar_torch.parallel.mesh import shard_batch

        train = shard_batch(train, mesh)
    _, metrics = task.train_step(task.state, train, torch.Generator().manual_seed(7))
    out = {"train": {k: v.item() for k, v in metrics.items()}, "grads": grads_to_numpy(task.model),
           "stats": {k: v.numpy().copy() for k, v in task.model.named_buffers()}}
    evaluated = task.eval_step(task.state, batch(case, 2, N_VALID))
    out["eval"] = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in evaluated.items()}
    return out


def _rank(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from tpuhar_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=WORLD)
    try:
        mesh = create_mesh()
        results = {case: run_case(case, mesh, presharded=case == "classify_plain") for case in CASES}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    torch.multiprocessing.start_processes(_rank, args=(free_port(), str(out)), nprocs=WORLD, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def world1():
    return {case: run_case(case) for case in CASES}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree(world2, case):
    """Every rank holds the global losses, gradients and outputs."""
    a, b = (w[case] for w in world2)
    assert a["train"] == b["train"]
    for (name, x), (_, y) in zip(_leaves(a["grads"]), _leaves(b["grads"])):
        np.testing.assert_array_equal(x, y, err_msg=name)
    for key in a["eval"]:
        np.testing.assert_array_equal(a["eval"][key], b["eval"][key], err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_world2_step_is_the_global_step(world2, world1, case):
    got, want = world2[0][case], world1[case]
    for key, value in want["train"].items():
        assert got["train"][key] == pytest.approx(value, rel=LOSS_RTOL, abs=1e-6), key
    grads, ref = dict(_leaves(got["grads"])), dict(_leaves(want["grads"]))
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in ref.values())
    for name, g in ref.items():
        np.testing.assert_allclose(grads[name], g, rtol=0, atol=GRAD_RTOL * np.abs(g).max() + floor, err_msg=name)
    for name, s in want["stats"].items():
        np.testing.assert_allclose(got["stats"][name], s, rtol=0, atol=STATS_ATOL, err_msg=name)
    for key, value in want["eval"].items():
        if key in ("preds", "valid", "n_valid"):
            np.testing.assert_array_equal(got["eval"][key], value, err_msg=key)
        elif np.ndim(value) == 0:
            assert float(got["eval"][key]) == pytest.approx(float(value), rel=LOSS_RTOL, abs=1e-6), key
        else:
            np.testing.assert_allclose(got["eval"][key], value, rtol=LOSS_RTOL, atol=1e-5, err_msg=key)


def test_eval_masks_by_global_row(world2):
    """``n_valid`` 5 of 8: rank 1 holds one valid row; the gathered mask is global."""
    out = world2[1]["classify"]["eval"]
    assert out["valid"].tolist() == [True] * N_VALID + [False] * (B - N_VALID)
    assert out["logits"].shape == (B, 4) and out["preds"].shape == (B,)
    assert world2[1]["pretrain"]["eval"]["n_valid"] == N_VALID


def _jax_config(cfg: Config):
    from tpuhar.config import Config as JConfig

    jcfg = JConfig()
    for section in ("model", "training", "data"):
        for key, value in vars(getattr(cfg, section)).items():
            setattr(getattr(jcfg, section), key, value)
    return jcfg


def _jax_mesh_losses(case: str) -> dict:
    """The JAX package's train and eval step on a ``(2, 1)`` mesh, from the same
    parameters and batches."""
    import jax
    from jax.sharding import Mesh

    from tpuhar.models.crossmodal import CrossModalModel as JCross, IMUClassifier as JIMU, VideoClassifier as JVideo
    from tpuhar.parallel.mesh import shard_batch, shard_state
    from tpuhar.train import steps as S
    from tpuhar.train.optim import make_classification_optimizer, make_pretrain_optimizer

    cfg = config(case)
    jcfg = _jax_config(cfg)
    variables = init_params(cfg, torch.Generator().manual_seed(0), model_cls(case))
    kind = case.split("_")[0]
    if kind == "pretrain":
        model = JCross(jcfg, train_loss_scalars=bool(jcfg.training.train_loss_scalars))
        tx = make_pretrain_optimizer(jcfg, 4)
        train_step, eval_step = S.make_crossmodal_steps(model, jcfg)
    else:
        model = JIMU(jcfg, freeze_encoder=False) if kind == "classify" else JVideo(jcfg)
        tx = make_classification_optimizer(jcfg, 4, "finetune", variables["params"])
        train_step, eval_step = (S.make_classification_steps if kind == "classify" else S.make_video_steps)(model, jcfg)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    state = shard_state(S.TrainState.create(params=variables["params"], batch_stats=variables["batch_stats"], tx=tx),
                        mesh)

    def jbatch(seed, n_valid=None):
        t = batch(case, seed, n_valid)
        out = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.int32(v)) for k, v in t.items()}
        out["label"] = out["label"].astype(np.int32)
        if kind == "tower":
            del out["imu"]
        return shard_batch(out, mesh)

    state, metrics = train_step(state, jbatch(1), jax.random.PRNGKey(0))
    evaluated = eval_step(state, jbatch(2, N_VALID))
    return {"train": {k: float(v) for k, v in metrics.items()},
            "eval": {k: np.asarray(v) for k, v in evaluated.items()}}


@pytest.mark.parametrize("case", ["pretrain_plain", "classify_plain", "tower"])
def test_world2_matches_jax_on_a_2x1_mesh(world2, case):
    got, want = world2[0][case], _jax_mesh_losses(case)
    for key, value in want["train"].items():
        assert got["train"][key] == pytest.approx(value, abs=JAX_ATOL, rel=JAX_ATOL), key
    loss_key = "loss" if case.startswith("pretrain") else "loss_sum"
    assert float(got["eval"][loss_key]) == pytest.approx(float(want["eval"][loss_key]), abs=JAX_ATOL, rel=JAX_ATOL)
    if "preds" in want["eval"]:
        np.testing.assert_array_equal(got["eval"]["preds"], want["eval"]["preds"])
