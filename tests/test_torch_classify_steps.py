"""The port's classification steps against the JAX package's, on the same parameters
and batches: the IMU classifier's linear probe and finetune, the video-only classifier
and the fusion classifier.

The model of ``tests/test_torch_pretrain_step.py`` cut to test size: ``videomae_tiny``
(4 blocks, d=192, 3 heads) on 4 frames of 32² with the flash attention
(``flash_kernel="library"``: JAX's ``flash_mha`` takes its XLA reference on the CPU, the
port ``FlashLean``'s plain path), ``video_d_model`` 64, the IMU encoder at d=32 with 2
layers, a classifier head 32 → 16 → 5 classes, f32, every dropout 0 so that the two
frameworks' random streams cannot matter, batch 4. JAX's ``init`` draws the parameters;
the port loads them through ``bridge``. The IMU classifier's head has the LayerNorm of
``entry.classify_config`` (the probe a BatchNorm head too), the video and fusion
classifiers' the BatchNorm of ``pretrain_config``. A BatchNorm head over 4 rows would make
every encoder gradient of the IMU finetune a sum whose terms cancel (35% of its elements
differ between the packages by more than 1e-4 of their size, against 0.4% with the
LayerNorm head), so that case leaves too few elements to hold tightly; the probe's
encoder has no gradient.

Tolerances, those of ``tests/test_torch_pretrain_step.py`` (f32 on both sides; only the
order of the sums differs):

- loss: 1e-5 relative, at the initial state and at each train step; accuracy exactly (4
  rows: each is 0, 25, 50, 75 or 100%);
- gradients, leaf by leaf: |port − JAX| ≤ 1e-4 · max|leaf| + 1e-5 · max|any gradient|;
- parameters after each of two ``train_step``s: an element whose gradient, at that step
  or an earlier one, lies within 100× that floor or differs between the packages by more
  than 1e-4 of its size (a sum whose terms cancel, so that rounding sets its last
  digits) is held to Adam's bound on its move, 2·Σlr of its group: AdamW's update
  m̂/(√v̂ + ε) turns a gradient's relative error into an error of up to about that much of
  lr. All others are held to 1e-6 + 1e-4·Σlr, and they must be at least 60% of the model
  (the probe's frozen encoder, whose gradient is 0, is held exactly: it must not move at
  all);
- BatchNorm running statistics after each step: 1e-5 absolute.

The second step starts, in both packages, from JAX's parameters and statistics after
the first. AdamW's first step moves each element by about ±lr whatever its gradient's
size, and the head's rate (1e-3) is ten times pretraining's: the noise-signed moves of
the first step changed the next step's gradients by up to 25% in the video classifier,
which would measure that chaos rather than the step;
- ``predict_step`` on a zero-padded batch with ``n_valid`` 3, both packages on the
  port's state after the two steps (so that the noise-signed moves above cannot enter):
  the logits and embeddings 1e-5 relative to their largest element, the predictions and
  the valid mask exactly, ``loss_sum`` 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar_torch import losses as L
from tpuhar_torch.bridge import grads_to_numpy, load_variables, variables_to_numpy
from tpuhar_torch.entry import build_classification_task, build_fusion_task, build_video_task, pretrain_config
from tpuhar_torch.ops.video import normalize_clip
from tpuhar_torch.train.optim import classification_schedule

torch.set_num_threads(2)

B, CLASSES = 4, 5
LOSS_RTOL, MOVED_LOSS_RTOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
PARAM_ATOL, PARAM_RTOL_LR = 1e-6, 1e-4
NOISE_FACTOR = 100
GRAD_AGREE = 1e-4
STATS_ATOL = 1e-5
OUT_RTOL = 1e-5
TIGHT_SHARE = 0.6


def _config(head_norm: str = "batch"):
    from tpuhar.config import Config

    cfg = Config()
    ours = pretrain_config()
    m = cfg.model
    m.use_flash_attention, m.flash_kernel = ours.model.use_flash_attention, ours.model.flash_kernel
    m.video_pretrained = ours.model.video_pretrained
    m.video_backbone, m.video_d_model = "videomae_tiny", 64
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 32, 4, 2
    m.fusion_heads = 4
    m.classifier_hidden_dims, m.num_classes = [32, 16], CLASSES
    m.compute_dtype = "float32"
    m.imu_dropout = m.classifier_dropout = 0.0
    m.head_norm = head_norm
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 4
    cfg.training.train_epochs = 3
    return cfg


def _batch(seed: int, n_valid=None):
    rng = np.random.default_rng(seed)
    batch = {
        "imu": rng.standard_normal((B, 6, 250)).astype(np.float32),
        "video": rng.integers(0, 256, (B, 4, 32, 32, 3), dtype=np.uint8),
        "label": rng.integers(0, CLASSES, (B,)).astype(np.int32),
    }
    if n_valid is not None:
        for key in ("imu", "video"):
            batch[key][n_valid:] = 0
        batch["n_valid"] = np.int32(n_valid)
    return batch


def _torch(batch):
    out = {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else int(v) for k, v in batch.items()}
    out["label"] = out["label"].long()
    return out


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


# each case: the model, the optimizer's mode and the head's norm
CASES = {
    "imu_linear_probe": ("imu", "linear_probe", "layer"),
    "imu_linear_probe_batchnorm": ("imu", "linear_probe", "batch"),
    "imu_finetune": ("imu", "finetune", "layer"),
    "video": ("video", "finetune", "batch"),
    "fusion": ("fusion", "finetune", "batch"),
}


def _float64(cfg) -> bool:
    """Whether ``cfg``'s model computes in float64. Its first gradient is then taken on
    the clip normalized in float64 by both packages: in f32 the two normalizations may
    round an element differently (one fused multiply-add or two roundings), and that
    comparison is made to see the gradient, not that. The train steps normalize in f32,
    in both packages, as they always do."""
    return cfg.model.compute_dtype == "float64"


def _jax_parts(kind: str, mode: str, cfg):
    """JAX's model, ``inputs(batch, dtype=f32)`` (the clip normalized in ``dtype``) and
    its steps."""
    from tpuhar.models.crossmodal import FusionClassifier, IMUClassifier, VideoClassifier
    from tpuhar.ops.video import normalize_clip as jax_normalize_clip
    from tpuhar.train import steps as jsteps

    if kind == "imu":
        return (IMUClassifier(cfg, freeze_encoder=mode == "linear_probe"), lambda b, dtype=jnp.float32: (b["imu"],),
                lambda model: jsteps.make_classification_steps(model, cfg))
    if kind == "video":
        return (VideoClassifier(cfg), lambda b, dtype=jnp.float32: (jax_normalize_clip(b["video"], dtype=dtype),),
                lambda model: jsteps.make_video_steps(model, cfg))
    return (FusionClassifier(cfg), lambda b, dtype=jnp.float32: (b["imu"], jax_normalize_clip(b["video"], dtype=dtype)),
            lambda model: jsteps.make_fusion_steps(model, cfg))


def _port_task(kind: str, mode: str, cfg, variables):
    if kind == "imu":
        return build_classification_task(cfg, mode, device="cpu", params=variables, steps_per_epoch=1)
    if kind == "video":
        return build_video_task(cfg, device="cpu", params=variables, steps_per_epoch=1)
    return build_fusion_task(cfg, device="cpu", params=variables, steps_per_epoch=1)


def _port_inputs(kind: str, tb, cfg):
    if kind == "imu":
        return (tb["imu"],)
    video = normalize_clip(tb["video"], dtype=torch.float64 if _float64(cfg) else torch.float32)
    return (video,) if kind == "video" else (tb["imu"], video)


@pytest.mark.parametrize("case", list(CASES))
def test_classification_step_matches_jax(case):
    kind, mode, head_norm = CASES[case]
    check_classification_step(kind, mode, _config(head_norm), _batch)


def check_classification_step(
    kind: str, mode: str, cfg, make_batch, tight_share: float = TIGHT_SHARE, jit_init: bool = False,
) -> None:
    """The loss and every gradient leaf at JAX's initial state, two ``train_step``s and
    a ``predict_step`` of the ``kind`` classifier ("imu", "video" or "fusion") in
    ``mode`` on JAX's configuration ``cfg``, against the JAX package's, with the
    tolerances of this file's docstring; ``make_batch(seed, n_valid=None)`` gives the
    numpy batches (4 rows); ``tight_share`` is the least share of the parameters held
    to the tight bound after each step; ``jit_init`` draws JAX's parameters under
    ``jax.jit`` (the same draws, rounded in their last bits otherwise than op by op, and
    one compile instead of one per operation of the model)."""
    from tpuhar import losses as JL
    from tpuhar.train.optim import make_classification_optimizer
    from tpuhar.train.steps import TrainState

    jmodel, jinputs, jsteps = _jax_parts(kind, mode, cfg)
    b0 = make_batch(0)
    init_inputs = [np.asarray(x, np.float32) for x in jinputs(b0)]
    draw = jax.jit(jmodel.init) if jit_init else jmodel.init
    variables = jax.device_get(draw(jax.random.PRNGKey(0), *init_inputs))
    variables = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    if _float64(cfg):  # JAX's state in float64 from the start, as its optimizer keeps it (exact: f32 values)
        variables = jax.tree.map(lambda v: np.asarray(v, np.float64), variables)

    def value_and_grad(dtype):
        def jax_loss(params, batch_stats, batch):
            (logits, _), _ = jmodel.apply({"params": params, "batch_stats": batch_stats}, *jinputs(batch, dtype),
                                          train=True, mutable=["batch_stats"])
            return JL.cross_entropy_loss(logits, batch["label"])

        return jax.jit(jax.value_and_grad(jax_loss))

    jax_value_and_grad = value_and_grad(jnp.float32)  # the clip as the train steps normalize it

    # -- the loss and every gradient leaf --------------------------------------------
    task = _port_task(kind, mode, cfg, variables)
    first = value_and_grad(jnp.float64) if _float64(cfg) else jax_value_and_grad
    want_loss, want_grads = first(variables["params"], variables["batch_stats"], b0)
    tb = _torch(b0)
    logits, _ = task.model.forward_cast(*_port_inputs(kind, tb, cfg), train=True)
    loss = L.cross_entropy_loss(logits, tb["label"])
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
        if mode == "linear_probe" and name.startswith("imu_encoder/"):
            assert not np.any(g) and not np.any(got[name]), name  # the frozen encoder: no gradient

    # -- two train steps against JAX's train_step, each from JAX's state -------------
    task = _port_task(kind, mode, cfg, variables)
    jstate = TrainState.create(params=variables["params"], batch_stats=variables["batch_stats"],
                               tx=make_classification_optimizer(cfg, 1, mode, variables["params"]))
    jtrain, jpredict = jsteps(jmodel)
    t = cfg.training
    schedules = {group: classification_schedule(lr, cfg, 1)
                 for group, lr in (("encoder", t.train_lr_encoder), ("head", t.train_lr_head))}
    init = dict(_flat(variables["params"]))
    noisy = None
    for step, seed in enumerate((1, 2)):
        if step:  # the port continues from JAX's parameters and statistics
            load_variables(task.model, jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats}))
        batch = make_batch(seed)
        _, g = jax_value_and_grad(jstate.params, jstate.batch_stats, batch)
        g = dict(_flat(jax.device_get(g)))
        jstate, jout = jtrain(jstate, batch, jax.random.PRNGKey(step))
        _, pout = task.train_step(task.state, _torch(batch), None)
        gp = dict(_flat(grads_to_numpy(task.model)))  # the port's gradient of this step
        gfloor = GRAD_FLOOR * max(np.abs(v).max() for v in g.values())
        step_noisy = {k: (np.abs(v) <= NOISE_FACTOR * gfloor) | (np.abs(gp[k] - v) > GRAD_AGREE * np.abs(v))
                      for k, v in g.items()}
        if mode == "linear_probe":  # zero gradient, zero update: held exactly below
            step_noisy = {k: v & (not k.startswith("imu_encoder/")) for k, v in step_noisy.items()}
        noisy = step_noisy if noisy is None else {k: noisy[k] | step_noisy[k] for k in g}
        np.testing.assert_allclose(pout["loss"].item(), float(jout["loss"]), rtol=LOSS_RTOL)
        assert pout["accuracy"].item() == float(jout["accuracy"])
        sum_lr = {group: sum(schedule(i) for i in range(step + 1)) for group, schedule in schedules.items()}
        port = variables_to_numpy(task.model)
        want = dict(_flat(jax.device_get(jstate.params)))
        got = dict(_flat(port["params"]))
        tight = sum(int((~noisy[k]).sum()) for k in want)
        share = tight / sum(v.size for v in want.values())
        assert share >= tight_share, (step, share)
        for name, w in want.items():
            encoder = name.startswith("imu_encoder/")
            if mode == "linear_probe" and encoder:  # the probe's encoder stays as it was, bit for bit
                assert np.array_equal(got[name], init[name]) and np.array_equal(w, init[name]), name
                continue
            lr = sum_lr["encoder" if encoder else "head"]
            err = np.abs(got[name] - w)
            assert np.all(err[~noisy[name]] <= PARAM_ATOL + PARAM_RTOL_LR * lr), (step, name, err[~noisy[name]].max())
            assert np.all(err <= 2 * lr), (step, name, err.max())
        stats = dict(_flat(port["batch_stats"]))
        for name, w in _flat(jax.device_get(jstate.batch_stats)):
            np.testing.assert_allclose(stats[name], w, rtol=0, atol=STATS_ATOL, err_msg=f"step {step} {name}")
    assert task.state.step == 2 and task.state.optimizer.count == 2

    # -- predict_step on a zero-padded batch, both on the port's state ---------------
    padded = make_batch(3, n_valid=3)
    jp = jax.device_get(jpredict(jstate.replace(params=port["params"], batch_stats=port["batch_stats"]), padded))
    pp = task.eval_step(task.state, _torch(padded))
    for key in ("logits", "embeddings"):
        np.testing.assert_allclose(pp[key].numpy(), jp[key], rtol=0, atol=OUT_RTOL * np.abs(jp[key]).max(), err_msg=key)
    assert np.array_equal(pp["preds"].numpy(), jp["preds"]) and np.array_equal(pp["valid"].numpy(), jp["valid"])
    assert pp["valid"].tolist() == [True, True, True, False]
    np.testing.assert_allclose(pp["loss_sum"].item(), float(jp["loss_sum"]), rtol=OUT_RTOL)
