"""The port's ``entry``, ``flagship_config(tiny=True)`` and ``dryrun_multichip`` against
``__graft_entry__``'s, on the CPU.

- ``dryrun_multichip(4, device="cpu")``: four spawned gloo ranks run the ``(2, 2)`` mesh
  and the pure-dp ``(4, 1)`` mesh, each a fully sharded fusion train step and the bf16
  and int8 engines, the int8 logits within 1e-5 of an engine's without a mesh. Its
  configuration has the dropout rates at 0 (as ``tests/test_torch_tp_jax.py`` has them)
  and its parameters are JAX's ``FusionClassifier.init(PRNGKey(0))`` carried across by
  the bridge: the ``(2, 2)`` mesh's loss equals the JAX package's one-device
  ``make_fusion_steps`` loss on the same batch to f32 rounding (``rtol`` 1e-5). The JAX
  step runs while the ranks do.
- ``dryrun_multichip(1, device="cpu")``, the degenerate mesh, at the default
  configuration, in a subprocess whose path shadows JAX and the JAX package with
  packages that fail to import: neither the caller nor its rank loads them.
- ``flagship_config(tiny=...)`` equals ``_flagship_config(tiny=...)`` field by field but
  for ``conv_backend`` (the port fuses the flagship's convs, a documented departure).
- ``entry()`` against ``__graft_entry__.entry()`` with both configurations swapped for
  ``tests/test_torch_slice.py``'s f32 cut (batch 8 from ``entry`` itself) and JAX's
  parameters carried across in place of the port's seed-0 draw: the same example shapes
  and outputs at that file's tolerance.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__  # noqa: E402
from tpuhar_torch import entry as port_entry  # noqa: E402
from tpuhar_torch.config import Config  # noqa: E402

from test_torch_slice import ATOL, _config as slice_config  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5


def _no_dropout(cfg):
    cfg.model.imu_dropout = cfg.model.classifier_dropout = 0.0
    return cfg


def _jax_loss(cfg, params, batch) -> float:
    """The JAX package's one-device fusion train step of ``cfg`` (``_dryrun_one_mesh``'s
    optimizer and step, no mesh) on ``params`` and ``batch``; its loss."""
    from tpuhar.models.crossmodal import FusionClassifier
    from tpuhar.train.optim import make_classification_optimizer
    from tpuhar.train.steps import TrainState, make_fusion_steps

    model = FusionClassifier(cfg)
    tx = make_classification_optimizer(cfg, 2, "finetune", params["params"])
    state = TrainState.create(params=params["params"], batch_stats=params.get("batch_stats", {}), tx=tx)
    train_step, _ = make_fusion_steps(model, cfg)
    _, metrics = train_step(state, batch, jax.random.PRNGKey(0))
    return float(metrics["loss"])


def _jax_entry():
    """``__graft_entry__.entry()`` with its configuration swapped for
    ``tests/test_torch_slice.py``'s f32 cut: ``(the parameters before folding, the
    example shapes, the inputs, JAX's outputs on them)``."""
    from unittest import mock

    jcfg = slice_config()
    with mock.patch.object(__graft_entry__, "_flagship_config", lambda tiny=False: jcfg):
        fn, (imu_example, video_example) = __graft_entry__.entry()
    rng = np.random.default_rng(0)
    imu = rng.normal(0, 8000.0, imu_example.shape).astype(np.float32)
    video = rng.integers(0, 256, video_example.shape, dtype=np.uint8)
    want = {k: np.asarray(v) for k, v in jax.jit(fn)(imu, video).items()}
    return jcfg, jax.device_get(fn._variables_prefold), (imu_example.shape, video_example.shape), (imu, video), want


def _one_rank_without_jax(tmp: Path) -> subprocess.Popen:
    """``dryrun_multichip(1, device="cpu")`` in a subprocess whose path shadows JAX and
    the JAX package with packages that fail to import."""
    shadow = tmp / "shadow"
    for name in ("jax", "jaxlib", "flax", "optax", "tpuhar"):
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(f"raise ImportError('{name} is shadowed')\n")
    script = tmp / "one_rank.py"
    script.write_text(_ONE_RANK)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(shadow), str(ROOT)])}
    return subprocess.Popen([sys.executable, str(script)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything the module compares, run at once: the one-rank subprocess; the port's
    dry run on four CPU ranks from JAX's initial parameters; JAX's ``entry()``; and,
    on this thread, the JAX step on the same parameters and batch."""
    from tpuhar.models.crossmodal import FusionClassifier

    one_rank = _one_rank_without_jax(tmp_path_factory.mktemp("one_rank"))
    jcfg = _no_dropout(__graft_entry__._flagship_config(tiny=True))
    jcfg.model.compute_dtype = "float32"
    d = jcfg.data
    H, W = d.video_resize
    T = d.video_frames_per_window
    params = jax.device_get(jax.jit(FusionClassifier(jcfg).init)(
        jax.random.PRNGKey(0), np.zeros((4, d.imu_channels, d.imu_window_size), np.float32),
        np.zeros((4, T, H, W, 3), np.float32)))
    cfg = _no_dropout(port_entry.flagship_config(tiny=True))
    batch = port_entry.dryrun_batch(port_entry.dryrun_config(cfg), 4)  # the (2, 2) mesh's B = 2·dp
    with ThreadPoolExecutor(max_workers=2) as pool:
        ranks = pool.submit(port_entry.dryrun_multichip, 4, device="cpu", config=cfg, params=params)
        entry = pool.submit(_jax_entry)
        jax_batch = {**batch, "label": batch["label"].astype(np.int32), "n_valid": np.int32(4)}
        loss = _jax_loss(jcfg, params, jax_batch)
        out, err = one_rank.communicate(timeout=300)
        return {"ranks": ranks.result(), "jax_loss": loss, "batch": batch, "entry": entry.result(),
                "one_rank": (one_rank.returncode, out, err)}


def test_dryrun_multichip_4_runs_both_meshes(world):
    ranks = world["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert [m["mesh"] for m in r["meshes"]] == [{"data": 2, "model": 2}, {"data": 4, "model": 1}]
        for m, batch in zip(r["meshes"], (4, 8)):
            assert m["batch"] == batch and np.isfinite(m["loss"])
            assert m["bf16_logits_shape"] == m["int8_logits_shape"] == (batch, 8)
            assert 0.0 <= m["int8_gap"] <= 1e-5
            # CPU tensors take the plain versions, which count no launch
            assert set(m["launches"]) == {"train", "bf16", "int8"}
            assert all(n == 0 for part in m["launches"].values() for n in part.values())
    for i in range(2):
        assert len({r["meshes"][i]["loss"] for r in ranks}) == 1


def test_dryrun_mesh_loss_matches_jax_one_device(world):
    got = world["ranks"][0]["meshes"][0]["loss"]
    assert got == pytest.approx(world["jax_loss"], rel=LOSS_RTOL)


def test_dryrun_batch_is_the_jax_draw(world):
    """The port's dry-run batch is the JAX function's ``np.random.default_rng(0)`` draw."""
    batch = world["batch"]
    cfg = __graft_entry__._flagship_config(tiny=True)
    d = cfg.data
    H, W = d.video_resize
    rng = np.random.default_rng(0)
    want = {
        "imu": rng.normal(size=(4, d.imu_channels, d.imu_window_size)).astype(np.float32),
        "video": (rng.random((4, d.video_frames_per_window, H, W, 3)) * 255).astype(np.uint8),
        "label": rng.integers(0, cfg.model.num_classes, size=4).astype(np.int32),
    }
    for key, value in want.items():
        np.testing.assert_array_equal(batch[key], value, err_msg=key)


_ONE_RANK = """
import sys
from tpuhar_torch.entry import dryrun_multichip


def main():
    (rank,) = dryrun_multichip(1, device="cpu")
    assert [m["mesh"] for m in rank["meshes"]] == [{"data": 1, "model": 1}], rank["meshes"]
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tpuhar"))
    assert not bad, bad


if __name__ == "__main__":
    main()
"""


def test_dryrun_multichip_1_without_jax(world):
    returncode, out, err = world["one_rank"]
    assert returncode == 0, err
    lines = [line for line in out.splitlines() if line.startswith("[dryrun_multichip]")]
    assert len(lines) == 4 and all(line.endswith("OK") for line in lines)
    assert "mesh={'data': 1, 'model': 1}, train loss=" in lines[0]


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "flagship"])
def test_flagship_config_matches_jax(tiny):
    ours = port_entry.flagship_config(tiny=tiny).to_dict()
    theirs = __graft_entry__._flagship_config(tiny=tiny).to_dict()
    assert ours["model"].pop("conv_backend") == "pallas"
    theirs["model"].pop("conv_backend")
    assert ours == theirs


def _port_config(jcfg) -> Config:
    cfg = Config()
    for section, values in jcfg.to_dict().items():
        for key, value in values.items():
            setattr(getattr(cfg, section), key, value)
    return cfg


def test_entry_matches_jax(world, monkeypatch):
    jcfg, params, (imu_shape, video_shape), (imu, video), want = world["entry"]
    monkeypatch.setattr(port_entry, "flagship_config", lambda *a, **k: _port_config(jcfg))
    monkeypatch.setattr(port_entry, "init_params", lambda *a, **k: params)  # JAX's, in place of seed 0's
    fn, (imu_example, video_example) = port_entry.entry(device="cpu")
    assert tuple(imu_example.shape) == imu_shape == (8, 250, 6)
    assert tuple(video_example.shape) == video_shape and video_example.dtype == torch.uint8
    got = fn(torch.from_numpy(imu), torch.from_numpy(video))
    assert set(got) == set(want) == {"logits", "msp", "energy", "embeddings"}
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value, atol=ATOL, rtol=0, err_msg=key)
