"""The port's tensor-parallel steps on a ``(2, 2)`` mesh against the JAX package's under
``shard_state`` on a ``(4, 2)`` mesh of the conftest's fake devices, on the CPU.

Four spawned ranks (gloo) run ``tests/test_torch_tp_steps.py``'s dropout-free cases,
``imu``, ``fusion`` and ``pretrain``, with its configuration (``tests/test_sharding.py``'s
``_cfg()`` widths, flash on, ``grad_clip_norm`` 1e-9 so that the clip engages, learning
rates 1e-2), parameters and batch; JAX's ``train_step`` (``make_classification_steps``,
``make_fusion_steps``, ``make_crossmodal_steps``) runs the same step from the same
parameters meanwhile, its optimizer behind a first stage that records the gradients it
is given. The loss, the gathered gradients, the gathered parameters after the step and
the BatchNorm statistics are held to JAX's with ``tests/test_torch_tp_steps.py``'s
tolerances (``assert_step_close``); every rank's loss is equal.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuhar_torch.bridge import init_params
from tpuhar_torch.config import Config

from test_torch_mesh import free_port
from test_torch_tp_steps import JAX_CASES, MESH, WORLD, assert_step_close, batch, config, kind, model_cls, run_case

torch.set_num_threads(2)


def _rank(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from tpuhar_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=WORLD)
    try:
        mesh = create_mesh(model_axis_size=MESH[1])
        torch.save({case: run_case(case, mesh) for case in JAX_CASES}, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The four ranks, started without waiting for them: JAX's steps run meanwhile."""
    out = tmp_path_factory.mktemp("tp_jax")
    ctx = torch.multiprocessing.start_processes(_rank, args=(free_port(), str(out)), nprocs=WORLD,
                                                start_method="spawn", join=False)
    yield out, ctx
    for process in ctx.processes:
        process.join(timeout=60)


@pytest.fixture(scope="module")
def jax_steps(spawned):
    return {case: _jax_step(case) for case in JAX_CASES}


@pytest.fixture(scope="module")
def world4(spawned, jax_steps):
    out, ctx = spawned
    while not ctx.join():
        pass
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _jax_config(cfg: Config):
    from tpuhar.config import Config as JConfig

    jcfg = JConfig()
    for section in ("model", "training", "data"):
        for key, value in vars(getattr(cfg, section)).items():
            setattr(getattr(jcfg, section), key, value)
    return jcfg


def _recording(tx):
    """``tx`` behind a stage that keeps the gradients it is given as its state and passes
    them on unchanged (``shard_state`` co-shards that state with the parameters)."""
    import jax
    import jax.numpy as jnp
    import optax

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def _jax_step(case: str) -> dict:
    """JAX's train step on a ``(4, 2)`` mesh under ``shard_state``; its gradients read
    from a first stage of its optimizer that records them (``_recording``)."""
    import jax
    from jax.sharding import Mesh

    from tpuhar.models.crossmodal import CrossModalModel as JCross, FusionClassifier as JFusion
    from tpuhar.models.crossmodal import IMUClassifier as JIMU
    from tpuhar.parallel.mesh import shard_batch, shard_state
    from tpuhar.train import steps as S
    from tpuhar.train.optim import make_classification_optimizer, make_pretrain_optimizer

    cfg = config(case)
    jcfg = _jax_config(cfg)
    variables = init_params(cfg, torch.Generator().manual_seed(0), model_cls(case))
    if kind(case) == "pretrain":
        model = JCross(jcfg, train_loss_scalars=bool(jcfg.training.train_loss_scalars))
        tx = make_pretrain_optimizer(jcfg, 4)
        train_step, _ = S.make_crossmodal_steps(model, jcfg)
    else:
        model = JIMU(jcfg, freeze_encoder=False) if kind(case) == "imu" else JFusion(jcfg)
        tx = make_classification_optimizer(jcfg, 4, "finetune", variables["params"])
        steps = S.make_classification_steps if kind(case) == "imu" else S.make_fusion_steps
        train_step, _ = steps(model, jcfg)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    state = shard_state(S.TrainState.create(params=variables["params"], batch_stats=variables["batch_stats"],
                                            tx=_recording(tx)), mesh)

    train = {k: v.numpy() for k, v in batch(1).items()}
    train["label"] = train["label"].astype(np.int32)
    state, metrics = train_step(state, shard_batch(train, mesh), jax.random.PRNGKey(0))
    return {"train": {k: float(v) for k, v in metrics.items()}, "grads": jax.device_get(state.opt_state[0]),
            "variables": {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}}


@pytest.mark.parametrize("case", JAX_CASES)
def test_tp_step_matches_jax_on_a_4x2_mesh(world4, jax_steps, case):
    got = world4[0][case]
    assert_step_close(got, jax_steps[case], got["before"], f"{case} against JAX")
    ranks = [r[case]["train"] for r in world4]
    assert all(r == ranks[0] for r in ranks)
