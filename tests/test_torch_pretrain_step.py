"""The port's pretraining step against the JAX package's, on the same parameters and
batches.

``entry.pretrain_config``'s model cut to test size: ``videomae_tiny`` (4 blocks, d=192,
3 heads) on 4 frames of 32² (8 tokens), ``video_d_model`` 64, the IMU encoder at d=32
with 2 layers, projection heads 32 → 16 with BatchNorm, f32, the flash attention
(``flash_kernel="library"``; JAX's ``flash_mha`` takes its XLA reference on the CPU, the
port ``FlashLean``'s plain path), dropout 0 so that the two frameworks' random streams
cannot matter, batch 4. JAX's ``CrossModalModel.init`` draws the parameters; the port
loads them through ``bridge``.

Tolerances (f32 on both sides; only the order of the sums differs):

- loss: 1e-5 relative at the initial state and at the first step; 1e-4 at the second
  step and at ``eval_step`` after it, which see the noise-signed moves described below;
- gradients (``bridge.grads_to_numpy`` against ``jax.value_and_grad``), leaf by leaf:
  |port − JAX| ≤ 1e-4 · max|leaf| + 1e-5 · max|any gradient|. The second term is the
  rounding floor: a bias that a BatchNorm follows, the key bias of an attention and a
  bias whose shift a later BatchNorm removes have gradient 0 in exact arithmetic, and
  hold only rounding noise of the sums around them;
- parameters after two ``train_step``s: AdamW turns every gradient into a step of about
  ±lr whatever its size, so an element whose gradient lies within 100× that floor at
  either step (JAX's gradient at the state before the step) takes its sign from the
  noise. Those elements are held to Adam's bound on the move, 2·Σlr; all others to
  1e-6 + 1e-4·Σlr, and they must be at least 60% of the model;
- BatchNorm running statistics after the two steps: 1e-5 absolute;
- ``eval_step`` with ``n_valid`` (running statistics, a zero-padded batch): as the loss.
"""
import jax
import numpy as np
import pytest
import torch

from tpuhar_torch.bridge import grads_to_numpy, variables_to_numpy
from tpuhar_torch.entry import build_pretrain_task, pretrain_config
from tpuhar_torch.ops.video import normalize_clip
from tpuhar_torch.train.steps import contrastive_loss_fn

torch.set_num_threads(2)

B = 4
LOSS_RTOL, MOVED_LOSS_RTOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
PARAM_ATOL, PARAM_RTOL_LR = 1e-6, 1e-4
NOISE_FACTOR = 100
STATS_ATOL = 1e-5
TIGHT_SHARE = 0.6  # the share of elements held to the tight bound: 0.74-0.86 in these cases


def _config(mode: str):
    from tpuhar.config import Config

    cfg = Config()
    ours = pretrain_config()
    m = cfg.model
    m.use_flash_attention, m.flash_kernel = ours.model.use_flash_attention, ours.model.flash_kernel
    m.video_pretrained = ours.model.video_pretrained
    m.video_backbone, m.video_d_model = "videomae_tiny", 64
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 32, 4, 2
    m.projection_dim, m.projection_hidden_dim = 16, 32
    m.compute_dtype = "float32"
    m.imu_dropout = 0.0
    assert m.head_norm == "batch" and cfg.training.train_loss_scalars
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 4
    cfg.training.replicate_siglip_sign_quirk = mode == "siglip_quirk"
    cfg.training.use_sigmoid_loss = mode != "infonce"
    return cfg


def _batch(seed: int, n_valid=None):
    rng = np.random.default_rng(seed)
    batch = {
        "imu": rng.standard_normal((B, 6, 250)).astype(np.float32),
        "video": rng.integers(0, 256, (B, 4, 32, 32, 3), dtype=np.uint8),
    }
    if n_valid is not None:
        batch["imu"][n_valid:] = 0
        batch["video"][n_valid:] = 0
        batch["n_valid"] = np.int32(n_valid)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else int(v) for k, v in batch.items()}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("mode", ["siglip", "siglip_quirk", "infonce"])
def test_pretrain_step_matches_jax(mode):
    from tpuhar import losses as JL
    from tpuhar.models.crossmodal import CrossModalModel
    from tpuhar.ops.video import normalize_clip as jax_normalize_clip
    from tpuhar.train.optim import make_pretrain_optimizer, pretrain_schedule
    from tpuhar.train.steps import TrainState, make_crossmodal_steps

    cfg = _config(mode)
    t = cfg.training
    jmodel = CrossModalModel(cfg, train_loss_scalars=True)
    b0 = _batch(0)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), b0["imu"], b0["video"].astype(np.float32)))

    def jax_loss(params, batch_stats, batch):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, batch["imu"],
            jax_normalize_clip(batch["video"]), train=True, mutable=["batch_stats"],
        )
        if t.use_sigmoid_loss:
            return JL.siglip_loss(out["imu_proj"], out["video_proj"], out["logit_scale"], out["logit_bias"],
                                  quirk_sign_flip=bool(t.replicate_siglip_sign_quirk))
        return JL.infonce_loss(out["imu_proj"], out["video_proj"], float(t.temperature))

    jax_value_and_grad = jax.jit(jax.value_and_grad(jax_loss))

    # -- the loss and every gradient leaf --------------------------------------------
    task = build_pretrain_task(cfg, device="cpu", params=variables, steps_per_epoch=1)
    want_loss, want_grads = jax_value_and_grad(variables["params"], variables["batch_stats"], b0)
    tb = _torch(b0)
    out = task.model.forward_cast(tb["imu"], normalize_clip(tb["video"]), train=True)
    loss = contrastive_loss_fn(cfg)(out)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    want = dict(_flat(jax.device_get(want_grads)))
    got = dict(_flat(grads_to_numpy(task.model)))
    assert got.keys() == want.keys()
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in want.values())
    for name, g in want.items():
        assert got[name].shape == g.shape, name
        err = np.abs(got[name] - g).max()
        assert err <= GRAD_RTOL * np.abs(g).max() + floor, (name, err, np.abs(g).max(), floor)

    # -- two train steps against JAX's train_step ------------------------------------
    task = build_pretrain_task(cfg, device="cpu", params=variables, steps_per_epoch=1)
    jstate = TrainState.create(
        params=variables["params"], batch_stats=variables["batch_stats"], tx=make_pretrain_optimizer(cfg, 1)
    )
    jtrain, jeval = make_crossmodal_steps(jmodel, cfg)
    schedule = pretrain_schedule(cfg, 1)
    noisy = None
    for step, seed in enumerate((1, 2)):
        batch = _batch(seed)
        _, g = jax_value_and_grad(jstate.params, jstate.batch_stats, batch)
        g = dict(_flat(jax.device_get(g)))
        gfloor = GRAD_FLOOR * max(np.abs(v).max() for v in g.values())
        step_noisy = {k: np.abs(v) <= NOISE_FACTOR * gfloor for k, v in g.items()}
        noisy = step_noisy if noisy is None else {k: noisy[k] | step_noisy[k] for k in g}
        jstate, jout = jtrain(jstate, batch, jax.random.PRNGKey(step))
        _, pout = task.train_step(task.state, _torch(batch), None)
        np.testing.assert_allclose(pout["loss"].item(), float(jout["loss"]), rtol=MOVED_LOSS_RTOL if step else LOSS_RTOL)
    assert task.state.step == 2 and task.state.optimizer.count == 2
    sum_lr = sum(float(schedule(i)) for i in range(2))
    port = variables_to_numpy(task.model)
    want = dict(_flat(jax.device_get(jstate.params)))
    got = dict(_flat(port["params"]))
    tight = sum(int((~noisy[k]).sum()) for k in want)
    assert tight >= TIGHT_SHARE * sum(v.size for v in want.values())
    for name, w in want.items():
        err = np.abs(got[name] - w)
        assert np.all(err[~noisy[name]] <= PARAM_ATOL + PARAM_RTOL_LR * sum_lr), (name, err[~noisy[name]].max())
        assert np.all(err <= 2 * sum_lr), (name, err.max())
    for name, w in _flat(jax.device_get(jstate.batch_stats)):
        np.testing.assert_allclose(dict(_flat(port["batch_stats"]))[name], w, rtol=0, atol=STATS_ATOL, err_msg=name)

    # -- eval_step on a zero-padded batch --------------------------------------------
    padded = _batch(3, n_valid=3)
    jev = jeval(jstate, padded)
    pev = task.eval_step(task.state, _torch(padded))
    assert int(pev["n_valid"]) == int(jev["n_valid"]) == 3
    np.testing.assert_allclose(pev["loss"].item(), float(jev["loss"]), rtol=MOVED_LOSS_RTOL)
