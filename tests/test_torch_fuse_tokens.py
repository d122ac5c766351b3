"""``FusionClassifier.fuse_with_tokens(..., train=True)``, the port's hook for video
towers other than its own, against the JAX package's and against the port's own
``forward``, on the CPU.

- Against JAX's ``apply(..., train=True, method=FusionClassifier.fuse_with_tokens,
  mutable=["batch_stats"])`` on ``tests/test_torch_classify_steps.py``'s tiny f32
  configuration (every dropout 0, so that the two frameworks' random streams cannot
  matter) and JAX's weights carried over through ``bridge``, with a BatchNorm and a
  LayerNorm head. That file's tolerances: the logits and the fused embedding 1e-5 of
  their largest element; the moved BatchNorm statistics 1e-5 absolute; the
  cross-entropy's gradients leaf by leaf, |port − JAX| ≤ 1e-4 · max|leaf| + 1e-5 ·
  max|any gradient|.
- The port alone, with dropout at its defaults, bf16 compute and f32 masters (so the
  cast at use matters): ``forward_cast(imu, tokens, method="fuse_with_tokens",
  train=True, generator=g)`` against ``forward_cast(imu, video, train=True,
  generator=g')``, ``g`` and ``g'`` seeded alike, the tokens the video encoder's in
  train mode: logits, fused, the head's moved statistics and every IMU-encoder, fusion
  and head gradient bit for bit. Two seeds give different logits, and the default call
  is the eval forward.
"""
import numpy as np
import pytest
import torch

from test_torch_classify_steps import GRAD_FLOOR, GRAD_RTOL, OUT_RTOL, STATS_ATOL, _config, _flat
from tpuhar_torch import losses as L
from tpuhar_torch.bridge import grads_to_numpy, init_params, variables_to_numpy
from tpuhar_torch.entry import build_fusion_task, pretrain_config
from tpuhar_torch.ops.video import normalize_clip

torch.set_num_threads(2)

B, TOKENS = 4, 8


def _leaf_rule(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in want.values())
    for name, g in want.items():
        err = np.abs(got[name] - g).max()
        assert err <= GRAD_RTOL * np.abs(g).max() + floor, (name, err, np.abs(g).max(), floor)


@pytest.mark.parametrize("head_norm", ["batch", "layer"])
def test_fuse_with_tokens_train_matches_jax(head_norm):
    import jax
    from tpuhar import losses as JL
    from tpuhar.models.crossmodal import FusionClassifier as JaxFusionClassifier

    cfg = _config(head_norm)
    jmodel = JaxFusionClassifier(cfg)
    rng = np.random.default_rng(11)
    imu = rng.standard_normal((B, 6, 250)).astype(np.float32)
    tokens = rng.standard_normal((B, TOKENS, cfg.model.video_d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.model.num_classes, (B,)).astype(np.int32)
    # JAX draws every parameter that fuse_with_tokens reaches; the video encoder, which it
    # does not reach, is the port's draw (the bridge needs a whole tree)
    drawn = jax.device_get(jax.jit(lambda key: jmodel.init(
        key, imu[:1], tokens[:1], method=JaxFusionClassifier.fuse_with_tokens))(jax.random.PRNGKey(0)))
    variables = {"params": dict(drawn["params"]), "batch_stats": dict(drawn.get("batch_stats", {}))}
    assert "video_encoder" not in variables["params"]
    variables["params"]["video_encoder"] = init_params(cfg, torch.Generator().manual_seed(0))["params"]["video_encoder"]

    def jax_loss(params, batch_stats):
        (logits, fused), moved = jmodel.apply({"params": params, "batch_stats": batch_stats}, imu, tokens,
                                              train=True, method=JaxFusionClassifier.fuse_with_tokens,
                                              mutable=["batch_stats"])
        return JL.cross_entropy_loss(logits, labels), (logits, fused, moved["batch_stats"])

    (_, (want_logits, want_fused, want_stats)), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        variables["params"], variables["batch_stats"])

    task = build_fusion_task(cfg, device="cpu", params=variables, steps_per_epoch=1)
    logits, fused = task.model.forward_cast(torch.from_numpy(imu), torch.from_numpy(tokens),
                                            method="fuse_with_tokens", train=True)
    L.cross_entropy_loss(logits, torch.from_numpy(labels).long()).backward()
    for got, want in ((logits, want_logits), (fused, want_fused)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=OUT_RTOL * np.abs(want).max())
    stats = dict(_flat(variables_to_numpy(task.model)["batch_stats"]))
    want_stats = dict(_flat(jax.device_get(want_stats)))
    assert stats.keys() == want_stats.keys()
    assert (head_norm == "batch") == any(k.startswith("classifier/") for k in want_stats)
    for name, w in want_stats.items():
        np.testing.assert_allclose(stats[name], w, rtol=0, atol=STATS_ATOL, err_msg=name)
    if head_norm == "batch":  # the head's statistics moved off their initial 0/1
        moved = [name for name, w in want_stats.items() if name.startswith("classifier/")
                 and not np.array_equal(w, dict(_flat(variables["batch_stats"]))[name])]
        assert moved
    _leaf_rule(dict(_flat(grads_to_numpy(task.model))), dict(_flat(jax.device_get(want_grads))))


def _bf16_config():
    """The port's tiny fusion classifier in bf16 with f32 masters and its dropout at
    the defaults (``imu_dropout`` 0.1, ``classifier_dropout`` 0.3), a BatchNorm head."""
    cfg = pretrain_config()
    m = cfg.model
    m.video_backbone, m.video_d_model = "videomae_tiny", 64
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 32, 4, 2
    m.fusion_heads = 4
    m.classifier_hidden_dims, m.num_classes = [32, 16], 5
    m.head_norm = "batch"
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 4
    assert m.compute_dtype == "bfloat16" and m.imu_dropout > 0 and m.classifier_dropout > 0
    return cfg


def _train_run(task, *inputs, method: str, seed: int):
    """Logits, fused, the moved buffers and every gradient of a cross-entropy step's
    forward and backward through ``forward_cast``."""
    g = torch.Generator().manual_seed(seed)
    logits, fused = task.model.forward_cast(*inputs, method=method, train=True, generator=g)
    L.cross_entropy_loss(logits, torch.arange(logits.shape[0]) % logits.shape[1]).backward()
    grads = {n: p.grad.clone() for n, p in task.model.named_parameters() if p.grad is not None}
    return logits.detach(), fused.detach(), {n: b.clone() for n, b in task.model.named_buffers()}, grads


def test_fuse_with_tokens_train_equals_forward_bitwise():
    cfg = _bf16_config()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    imu = torch.from_numpy(rng.standard_normal((B, 6, 250)).astype(np.float32))
    clip = rng.integers(0, 256, (B, 4, 32, 32, 3), dtype=np.uint8)
    video = normalize_clip(torch.from_numpy(clip))

    whole = build_fusion_task(cfg, device="cpu", params=params, steps_per_epoch=1)
    split = build_fusion_task(cfg, device="cpu", params=params, steps_per_epoch=1)
    assert all(p.dtype == torch.float32 for p in split.model.parameters())
    assert split.model.use_dtypes["imu_to_fusion.weight"] == torch.bfloat16
    initial = {n: b.clone() for n, b in split.model.named_buffers()}
    with torch.no_grad():
        _, tokens = split.model.forward_cast(video, method="video_encoder", train=True)
    logits, fused, buffers, grads = _train_run(whole, imu, video, method="forward", seed=5)
    got_logits, got_fused, got_buffers, got_grads = _train_run(split, imu, tokens, method="fuse_with_tokens", seed=5)
    assert torch.equal(got_logits, logits) and torch.equal(got_fused, fused)
    assert got_buffers.keys() == buffers.keys()
    head = [n for n in buffers if n.startswith("classifier.")]
    assert head and all(not torch.equal(buffers[n], initial[n]) for n in head)  # the head's statistics moved
    for name, b in buffers.items():
        assert torch.equal(got_buffers[name], b), name
    compared = [n for n in grads if not n.startswith("video_encoder.")]
    assert set(got_grads) == set(compared)
    for name in compared:
        assert torch.equal(got_grads[name], grads[name]), name

    # dropout is live: another seed gives other logits
    other, *_ = _train_run(split, imu, tokens, method="fuse_with_tokens", seed=6)
    assert not torch.equal(other, got_logits)
    # the default is the eval forward
    with torch.no_grad():
        want_logits, want_fused = whole.model.forward_cast(imu, video)
        _, eval_tokens = whole.model.forward_cast(video, method="video_encoder")
        got = whole.model.forward_cast(imu, eval_tokens, method="fuse_with_tokens")
    assert torch.equal(got[0], want_logits) and torch.equal(got[1], want_fused)
