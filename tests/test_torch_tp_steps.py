"""Tensor-parallel training and serving of the port (``parallel/``, ``train/``, ``serving``
over a ``(2, 2)`` mesh) on the CPU: four spawned processes on gloo against one process.
``tests/test_torch_tp_jax.py`` holds the same steps to the JAX package's under
``shard_state`` on a ``(4, 2)`` mesh of the conftest's fake devices.

One spawn of four ranks (``torch.multiprocessing``, gloo on a free port, mesh ``(2,
2)``: data and model axes acting together, rank ``k`` at ``(k // 2, k % 2)``) runs every
case on a global batch of 8 (4 rows a data rank), from the same parameters
(``bridge.init_params``) and the same generator on every rank. ``tests/test_sharding.py``'s
``_cfg()`` widths (IMU d=64, 4 heads split 2 + 2, d_ff 256 split; ``videomae_tiny``'s 3
heads stay whole while its MLP splits; fusion heads 4), f32, flash on (its plain version
here). ``grad_clip_norm`` 1e-9, so that the clip engages and leaves every clipped
gradient element ``1e-9 · g / ‖g‖`` below a tenth of AdamW's eps (1e-8): a first update
is then close to proportional to ``g / ‖g‖``, and holds the norm the clip computed over
the model group. Every learning rate is 1e-2 (no warmup), so that the updates, about
``1e-3 · |g| / ‖g‖``, stand above the rounding of the parameters they move.

- ``imu``, ``fusion``, ``pretrain`` (BatchNorm projection heads, SigLIP), dropout 0:
  the loss, the gathered gradients (before the clip), the gathered parameters after the
  step, the BatchNorm statistics and the eval outputs against the port's one-process
  step;
- ``imu_dropout`` (dropout 0.1 with augmentation), ``fusion_dropout`` (dropout 0.1 in
  the cross-attention blocks and the head), ``pretrain_remat`` (IMU dropout 0.1,
  ``remat_video``: the ViT blocks' recompute replays their collectives): against the
  port's one-process step from the same generator (JAX's random streams differ);
- every rank's losses and eval outputs are equal, bit for bit;
- a checkpoint the fusion case saves under TP before its step equals, name for name, the
  one saved without a mesh bit for bit (parameters, moments, counts); after the step the
  names and shapes are equal and the values within the parameters' tolerance;
  ``ClassificationTrainer.resume`` on a fresh split task restores each rank's shard bit
  for bit; ``InferenceEngine.from_checkpoint`` serves the TP checkpoint bit for bit as
  an engine of the gathered variables;
- ``InferenceEngine(mesh=)`` on the ``(2, 2)`` mesh (whole parameters, rows over the
  data axis) against the engine without a mesh: ``preds`` equal, values within 1e-4
  (``tests/test_torch_engine_mesh.py``'s bound).

Tolerances (f32 on both sides; the sums are ordered differently):

- losses and eval sums: 1e-5 relative;
- gradients leaf by leaf: ``|got − want| ≤ 1e-4 · max|leaf| + 1e-5 · max|any
  gradient|`` (``tests/test_torch_pretrain_step.py``'s bound);
- parameters after the step: ``|got − want| ≤ 1e-3 · max|leaf's update| + 1e-5 · max|any
  update| + 2⁻²² · max|leaf|``. Near-proportional, an update carries the gradient's
  error relative to the leaf's largest element (the 1e-4 and 1e-5 above), with 10× room
  for the curvature of ``x / (|x| + eps)`` and the norm's own error; plus two f32 ulps of
  the parameter it was added to;
- BatchNorm running statistics: 1e-5 absolute.

Two kinds of gradient are 0 in exact arithmetic and hold only the rounding noise of the
sums around them: an attention's key bias (the softmax is invariant to ``q·b``) and the
bias of a projection head's first dense, which a BatchNorm follows. Both sides' values of
those leaves are held below 1e-4 of the largest gradient, and their parameters after the
step within 2e-4 of the largest update (plus the ulps), instead of to each other.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuhar_torch.bridge import grads_to_numpy, init_params, variables_to_numpy
from tpuhar_torch.config import Config
from tpuhar_torch.models.crossmodal import CrossModalModel, FusionClassifier, IMUClassifier

from test_torch_mesh import free_port

torch.set_num_threads(2)

WORLD, MESH, B, N_VALID = 4, (2, 2), 8, 5
JAX_CASES = ("imu", "fusion", "pretrain")
CASES = JAX_CASES + ("imu_dropout", "fusion_dropout", "pretrain_remat")
CLIP, LR = 1e-9, 1e-2
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR, STATS_ATOL = 1e-5, 1e-4, 1e-5, 1e-5
UPDATE_RTOL, UPDATE_FLOOR, PARAM_ULPS = 1e-3, 1e-5, 2.0**-22
ENGINE_ATOL, ENGINE_SIZES, ENGINE_REQUESTS = 1e-4, [4, 8], (8, 5)
VANISHING, VANISHING_SHARE = re.compile(r".*(/key/bias|_proj/fc1/bias)$"), 1e-4


def config(case: str) -> Config:
    cfg = Config()
    m, d = cfg.model, cfg.data
    m.num_classes, m.imu_num_layers, m.imu_d_model, m.imu_nhead = 4, 2, 64, 4
    m.compute_dtype, m.projection_dim, m.projection_hidden_dim, m.classifier_hidden_dims = "float32", 16, 32, [32]
    m.video_backbone, m.video_d_model, m.fusion_heads = "videomae_tiny", 64, 4
    m.use_flash_attention, m.flash_kernel, m.video_pretrained = True, "library", False
    m.head_norm = "batch" if case.startswith("pretrain") else "layer"
    drop = 0.0 if case in JAX_CASES else 0.1
    m.imu_dropout, m.classifier_dropout = drop, drop
    m.remat_video = case == "pretrain_remat"
    d.use_augmentation = case == "imu_dropout"
    d.video_resize, d.video_frames_per_window = (32, 32), 4
    t = cfg.training
    t.grad_clip_norm, t.pretrain_lr, t.train_lr_head, t.train_lr_encoder, t.pretrain_warmup_epochs = CLIP, LR, LR, LR, 0
    return cfg


def kind(case: str) -> str:
    return case.split("_")[0]


def model_cls(case: str):
    return {"imu": IMUClassifier, "fusion": FusionClassifier, "pretrain": CrossModalModel}[kind(case)]


def build_task(case: str, mesh=None):
    from tpuhar_torch.train import factory

    cfg = config(case)
    params = init_params(cfg, torch.Generator().manual_seed(0), model_cls(case))
    if kind(case) == "pretrain":
        return factory.build_crossmodal_task(cfg, 4, params, device="cpu", mesh=mesh)
    if kind(case) == "imu":
        return factory.build_classification_task(cfg, "finetune", 4, params, device="cpu", mesh=mesh)
    return factory.build_fusion_task(cfg, 4, params, device="cpu", mesh=mesh)


def batch(seed: int, n_valid=None) -> dict:
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


def whole_trees(case: str, model) -> tuple:
    """``(variables, gradients)`` of a (split or whole) model as flax-layout trees of the
    whole model: the split tensors gathered over the model group."""
    from tpuhar_torch.parallel.mesh import whole_tensors

    grads = whole_tensors(model, {n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    whole = model_cls(case)(config(case), dtype=torch.float32)
    whole.load_state_dict(whole_tensors(model, model.state_dict()))
    for name, p in whole.named_parameters():
        p.grad = grads.get(name)
    return variables_to_numpy(whole), grads_to_numpy(whole)


def run_case(case: str, mesh=None) -> dict:
    """One train step and one eval step of ``case``: losses, the whole gradients and
    variables after the step, the eval outputs, as numpy."""
    task = build_task(case, mesh)
    before, _ = whole_trees(case, task.model)
    _, metrics = task.train_step(task.state, batch(1), torch.Generator().manual_seed(7))
    variables, grads = whole_trees(case, task.model)
    evaluated = task.eval_step(task.state, batch(2, N_VALID))
    return {"train": {k: v.item() for k, v in metrics.items()}, "before": before, "variables": variables,
            "grads": grads, "eval": {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in evaluated.items()}}


def checkpoint_case(save_dir: Path, mesh=None) -> dict:
    """The fusion case's checkpoints: ``initial`` before a step and ``last`` after it;
    under a mesh also a fresh split task resumed from ``last`` and compared with the
    state that wrote it, rank by rank."""
    from tpuhar_torch.train import checkpoint as ckpt
    from tpuhar_torch.train.loop import ClassificationTrainer

    task = build_task("fusion", mesh)
    ckpt.save_checkpoint(save_dir / "initial", task.state, mesh=mesh)
    task.train_step(task.state, batch(1), torch.Generator().manual_seed(7))
    ckpt.save_checkpoint(save_dir / "last", task.state, extra={"epoch": 0}, mesh=mesh)
    out = {"variables": whole_trees("fusion", task.model)[0]}
    if mesh is None:
        return out
    fresh, cfg = build_task("fusion", mesh), config("fusion")
    cfg.paths.logs_dir = str(save_dir / "logs")
    trainer = ClassificationTrainer(cfg, fresh.state, fresh.train_step, fresh.eval_step, save_dir,
                                    None, "finetune", mesh=mesh)
    out["resumed"] = trainer.resume()
    sd, opt = task.model.state_dict(), task.state.optimizer
    mine, mopt = trainer.state.model.state_dict(), trainer.state.optimizer
    out["differ"] = [n for n, t in sd.items() if t.shape != mine[n].shape or not torch.equal(t, mine[n])]
    out["moments_equal"] = all(torch.equal(a, b) for a, b in zip([*opt.mu, *opt.nu], [*mopt.mu, *mopt.nu]))
    out["counts"] = (trainer.state.step, mopt.count, task.state.step, opt.count, trainer.current_epoch)
    out["split"] = sorted(trainer.state.model.tp_dims)
    return out


def serve(mesh=None) -> list:
    from tpuhar_torch.serving import InferenceEngine

    cfg = config("fusion")
    engine = InferenceEngine(cfg, init_params(cfg, torch.Generator().manual_seed(0)), batch_sizes=ENGINE_SIZES,
                             mesh=mesh, device="cpu")
    rng = np.random.default_rng(3)
    return [engine.predict(rng.normal(0, 8000, (n, 250, 6)).astype(np.float32),
                           rng.integers(0, 256, (n, 4, 32, 32, 3), dtype=np.uint8)) for n in ENGINE_REQUESTS]


def _rank(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from tpuhar_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=WORLD)
    try:
        mesh = create_mesh(model_axis_size=MESH[1])
        results = {case: run_case(case, mesh) for case in CASES}
        results["checkpoint"] = checkpoint_case(Path(out_dir) / "tp_fusion", mesh)
        results["engine"] = serve(mesh)
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    torch.multiprocessing.start_processes(_rank, args=(free_port(), str(out)), nprocs=WORLD, start_method="spawn")
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    out = tmp_path_factory.mktemp("one")
    results = {case: run_case(case) for case in CASES}
    results["checkpoint"] = checkpoint_case(out / "one_fusion")
    results["engine"] = serve()
    return out, results


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def assert_step_close(got: dict, want: dict, before: dict, what: str) -> None:
    """``got`` (loss, gradients, variables after the step) within the module's
    tolerances of ``want``; ``before`` is the variables the step started from."""
    for key, value in want["train"].items():
        assert got["train"][key] == pytest.approx(value, rel=LOSS_RTOL, abs=1e-6), (what, key)
    grads, ref = dict(_leaves(got["grads"])), dict(_leaves(want["grads"]))
    assert grads.keys() == ref.keys()
    largest = max(np.abs(g).max() for g in ref.values())
    for name, g in ref.items():
        if VANISHING.match(name):
            assert max(np.abs(g).max(), np.abs(grads[name]).max()) <= VANISHING_SHARE * largest, (what, name)
            continue
        np.testing.assert_allclose(grads[name], g, rtol=0, atol=GRAD_RTOL * np.abs(g).max() + GRAD_FLOOR * largest,
                                   err_msg=f"{what} gradient {name}")
    params, ref, start = (dict(_leaves(t["params"])) for t in (got["variables"], want["variables"], before))
    assert params.keys() == ref.keys()
    updates = {name: ref[name] - start[name] for name in ref}
    largest = max(np.abs(u).max() for u in updates.values())
    for name, w in ref.items():
        ulps = PARAM_ULPS * np.abs(w).max()
        if VANISHING.match(name):
            atol = 2 * VANISHING_SHARE * largest + ulps
        else:
            atol = UPDATE_RTOL * np.abs(updates[name]).max() + UPDATE_FLOOR * largest + ulps
        np.testing.assert_allclose(params[name], w, rtol=0, atol=atol, err_msg=f"{what} parameter {name}")
    stats, ref = dict(_leaves(got["variables"]["batch_stats"])), dict(_leaves(want["variables"]["batch_stats"]))
    assert stats.keys() == ref.keys()
    for name, s in ref.items():
        np.testing.assert_allclose(stats[name], s, rtol=0, atol=STATS_ATOL, err_msg=f"{what} statistic {name}")


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree(world4, case):
    """Every rank holds the global losses, the same gathered state and the global eval
    outputs."""
    ranks = [r[case] for r in world4[1]]
    for other in ranks[1:]:
        assert other["train"] == ranks[0]["train"]
        for (name, x), (_, y) in zip(_leaves(ranks[0]["variables"]), _leaves(other["variables"])):
            np.testing.assert_array_equal(x, y, err_msg=name)
        for key in ranks[0]["eval"]:
            np.testing.assert_array_equal(ranks[0]["eval"][key], other["eval"][key], err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_tp_step_is_the_one_process_step(world4, world1, case):
    got, want = world4[1][0][case], world1[1][case]
    assert_step_close(got, want, want["before"], case)
    for key, value in want["eval"].items():
        if key in ("preds", "valid", "n_valid"):
            np.testing.assert_array_equal(got["eval"][key], value, err_msg=key)
        else:
            np.testing.assert_allclose(got["eval"][key], value, rtol=LOSS_RTOL, atol=1e-5, err_msg=key)


def test_tp_checkpoints_are_mesh_independent(world4, world1):
    tp_dir, one_dir = world4[0] / "tp_fusion", world1[0] / "one_fusion"
    initial, want = (torch.load(d / "initial.pt", weights_only=True) for d in (tp_dir, one_dir))
    assert initial["model"].keys() == want["model"].keys() and initial["step"] == want["step"] == 0
    for name, t in want["model"].items():
        assert torch.equal(initial["model"][name], t), name
    assert initial["optimizer"]["count"] == want["optimizer"]["count"] == 0
    for key in ("mu", "nu"):
        assert [t.shape for t in initial["optimizer"][key]] == [t.shape for t in want["optimizer"][key]]
    last, want = (torch.load(d / "last.pt", weights_only=True) for d in (tp_dir, one_dir))
    assert last["step"] == want["step"] == 1 and last["optimizer"]["count"] == want["optimizer"]["count"] == 1
    assert {n: t.shape for n, t in last["model"].items()} == {n: t.shape for n, t in want["model"].items()}
    for key in ("mu", "nu"):
        assert [t.shape for t in last["optimizer"][key]] == [t.shape for t in want["optimizer"][key]]
    # the values after the step: the parameters' tolerance, on the gathered trees
    got, ref = world4[1][0]["checkpoint"], world1[1]["checkpoint"]
    assert_step_close({**world4[1][0]["fusion"], "variables": got["variables"]},
                      {**world1[1]["fusion"], "variables": ref["variables"]}, world1[1]["fusion"]["before"],
                      "checkpoint")


def test_resume_shards_the_checkpoint_again(world4):
    for rank, r in enumerate(world4[1]):
        c = r["checkpoint"]
        assert c["resumed"] and not c["differ"] and c["moments_equal"], (rank, c["differ"])
        assert c["counts"] == (1, 1, 1, 1, 1) and len(c["split"]) > 0


def test_from_checkpoint_serves_the_tp_checkpoint(world4):
    from tpuhar_torch.serving import InferenceEngine

    cfg = config("fusion")
    served = InferenceEngine.from_checkpoint(cfg, world4[0] / "tp_fusion" / "last", batch_sizes=[8], device="cpu")
    gathered = InferenceEngine(cfg, world4[1][0]["checkpoint"]["variables"], batch_sizes=[8], device="cpu")
    rng = np.random.default_rng(5)
    args = (rng.normal(0, 8000, (8, 250, 6)).astype(np.float32), rng.integers(0, 256, (8, 4, 32, 32, 3), np.uint8))
    got, want = served.predict(*args), gathered.predict(*args)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_engine_on_a_2x2_mesh_matches_the_engine_without_one(world4, world1):
    for rank, r in enumerate(world4[1]):
        for got, want in zip(r["engine"], world1[1]["engine"]):
            np.testing.assert_array_equal(got["preds"], want["preds"])
            for key in ("logits", "msp", "energy", "embeddings"):
                np.testing.assert_allclose(got[key], want[key], rtol=0, atol=ENGINE_ATOL, err_msg=f"rank {rank} {key}")
