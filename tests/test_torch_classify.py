"""The classification stage's pieces against the JAX package's, on the same numpy
inputs: the losses (``tpuhar_torch/losses.py``), the confusion-matrix metrics
(``eval/metrics.py``), the IMU augmentation (``ops/augment.py``), the schedule and the
optimizers (``train/optim.py``), and the dropout masks of the classifier head and the
cross-attention blocks.

Tolerances: the losses' values and gradients 1e-5 relative (atol 1e-7 for gradient
elements near 0), f32, only the order of the sums differs; the confusion matrices
exactly and their metrics to 1e-12 (the same float64 arithmetic); the augmentation,
fed the draws ``jax.random`` makes for the same key split, 1e-5 absolute on z-scored
windows of white noise, plus for the time warp what one ulp of a read position moves a
linear interpolation: 2·ulp(T)·max|x[t+1] − x[t]| (XLA's ``sin`` and PyTorch's differ by
an ulp, and a read position near T = 250 has ulps of 1.5e-5, so the positions agree to
an ulp and no closer); the schedule and the optimizers' parameters and moments 1e-6
relative, as in ``tests/test_torch_optim.py``; the linear probe's encoder bit for bit.
The dropout masks are held on their own: the same generator seed gives the same mask,
and the kept share lies within 3σ of 1 − rate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuhar_torch import losses as L
from tpuhar_torch.eval import metrics as M
from tpuhar_torch.models.layers import ClassifierHead, CrossAttentionBlock, dropout
from tpuhar_torch.ops import augment as A
from tpuhar_torch.train import optim

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-7
AUG_ATOL = 1e-5
OPT_RTOL = 1e-6


def _warp_atol(x: np.ndarray) -> float:
    """``AUG_ATOL`` plus what two ulps of a read position near the window's end move a
    linear interpolation of ``x``."""
    T = x.shape[-1]
    return AUG_ATOL + 2 * float(np.spacing(np.float32(T - 1))) * float(np.abs(np.diff(x, axis=-1)).max())


def _logits(seed: int, b: int = 6, n: int = 5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)) * 3).astype(np.float32), rng.integers(0, n, (b,)).astype(np.int32)


LOSS_CASES = {
    "cross_entropy": ("cross_entropy", {}),
    "focal": ("focal", {}),
    "focal_alpha_gamma": ("focal", {"alpha": 0.25, "gamma": 1.5}),
    "label_smoothing": ("label_smoothing", {}),
    "label_smoothing_0.3": ("label_smoothing", {"epsilon": 0.3}),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_classification_losses_match_jax(case, reduction):
    """Each loss through ``get_loss_function``: the value (per row with "none") and the
    gradient of its sum with respect to the logits."""
    from tpuhar import losses as JL

    name, kwargs = LOSS_CASES[case]
    logits, labels = _logits(0)
    jfn = JL.get_loss_function(name, reduction=reduction, **kwargs)
    pfn = L.get_loss_function(name, reduction=reduction, **kwargs)
    want, want_grad = jax.value_and_grad(lambda x: jnp.sum(jfn(x, jnp.asarray(labels))))(jnp.asarray(logits))
    want_value = np.asarray(jfn(jnp.asarray(logits), jnp.asarray(labels)))
    leaf = torch.tensor(logits, requires_grad=True)
    got = pfn(leaf, torch.from_numpy(labels).long())
    assert tuple(got.shape) == want_value.shape
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want_value, rtol=RTOL)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)


def test_weighted_cross_entropy_matches_jax():
    from tpuhar import losses as JL

    logits, labels = _logits(1)
    weights = np.asarray([0.5, 2.0, 1.0, 0.0, 3.0], np.float32)
    want, want_grad = jax.value_and_grad(
        lambda x: JL.weighted_cross_entropy_loss(x, jnp.asarray(labels), jnp.asarray(weights))
    )(jnp.asarray(logits))
    leaf = torch.tensor(logits, requires_grad=True)
    got = L.weighted_cross_entropy_loss(leaf, torch.from_numpy(labels).long(), torch.from_numpy(weights))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)


def test_get_loss_function_names():
    assert L.get_loss_function("infonce") is L.infonce_loss
    assert L.get_loss_function("sigmoid_contrastive") is L.siglip_loss
    with pytest.raises(ValueError, match="Unknown loss function"):
        L.get_loss_function("hinge")


@pytest.mark.parametrize("case", ["all_classes", "absent_classes", "padded_rows", "empty"])
def test_metrics_from_confusion_match_jax(case):
    """Two batches scattered into the confusion matrix, the second zero-padded past its
    valid rows: the matrices equal, and so do sklearn's metrics derived from them
    (present-class semantics: a class absent from y_true and y_pred scores nothing, one
    predicted but never true scores 0)."""
    from tpuhar.eval import metrics as JM

    rng = np.random.default_rng(2)
    C, B = 6, 8
    labels = rng.integers(0, C, (2, B)).astype(np.int32)
    preds = np.where(rng.random((2, B)) < 0.6, labels, rng.integers(0, C, (2, B))).astype(np.int32)
    valid = np.ones((2, B), bool)
    if case == "absent_classes":  # classes 4 and 5 never true; 5 predicted twice
        labels %= 4
        preds = np.where(preds == 4, 0, preds)
        preds[0, :2] = 5
    if case == "padded_rows":
        valid[1, 5:] = False
        labels[1, 5:] = 0  # padding rows carry label 0 and whatever prediction
    if case == "empty":
        valid[:] = False
    jcm, pcm = JM.init_confusion(C), M.init_confusion(C)
    for i in range(2):
        jcm = JM.confusion_update(jcm, jnp.asarray(labels[i]), jnp.asarray(preds[i]), jnp.asarray(valid[i]))
        pcm = M.confusion_update(pcm, torch.from_numpy(labels[i]), torch.from_numpy(preds[i]), torch.from_numpy(valid[i]))
    assert pcm.dtype == torch.float32 and np.array_equal(pcm.numpy(), np.asarray(jcm))
    want, got = JM.metrics_from_confusion(jcm), M.metrics_from_confusion(pcm)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12, abs=1e-12), key
    if case == "absent_classes":
        from sklearn.metrics import balanced_accuracy_score, f1_score

        y, p = labels.ravel(), preds.ravel()
        assert got["balanced_accuracy"] == pytest.approx(100 * balanced_accuracy_score(y, p))
        assert got["f1_macro"] == pytest.approx(100 * f1_score(y, p, average="macro"))


def _windows(seed: int, shape=(3, 6, 250)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("strength", [0.0, 0.1, 0.5])
def test_jitter_matches_jax(strength):
    from tpuhar.ops import augment as JA

    x = _windows(3)
    key = jax.random.PRNGKey(7)
    want = np.asarray(JA.jitter(jnp.asarray(x), key, strength))
    noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float32)))
    got = A.jitter_from_noise(torch.from_numpy(x), noise, strength)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUG_ATOL)


@pytest.mark.parametrize("T", [250, 97])
@pytest.mark.parametrize("strength", [0.0, 0.2, 1.0])
def test_time_warp_matches_jax(strength, T):
    from tpuhar.ops import augment as JA

    x = _windows(4, (3, 6, T))
    key = jax.random.PRNGKey(11)
    want = np.asarray(JA.time_warp(jnp.asarray(x), key, strength))
    offsets = torch.from_numpy(np.array(jax.random.normal(key, (3, A.KNOTS), jnp.float32)))
    got = A.time_warp_from_offsets(torch.from_numpy(x), offsets, strength)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_warp_atol(x))
    if strength:  # the window's span is kept: both end samples stay where they were
        assert np.array_equal(got.numpy()[..., [0, -1]], x[..., [0, -1]])


@pytest.mark.parametrize("enabled", [True, False])
def test_augment_imu_matches_jax(enabled):
    """The chain, time warp then jitter, fed the draws of ``jax.random.split(key)``: the
    time warp's offsets from the first key, the jitter's noise from the second. The
    port's ``augment_imu`` draws the offsets, then the noise, from its generator: the
    same seed gives the same windows, and they are the cores' on those draws."""
    from tpuhar.config import Config
    from tpuhar.ops import augment as JA

    cfg = Config()
    cfg.data.use_augmentation = enabled
    tw, js = cfg.data.time_warp_strength, cfg.data.jitter_strength = 0.3, 0.2
    x = _windows(5)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JA.augment_imu(jnp.asarray(x), key, cfg))
    k1, k2 = jax.random.split(key)
    offsets = torch.from_numpy(np.array(jax.random.normal(k1, (x.shape[0], A.KNOTS), jnp.float32)))
    noise = torch.from_numpy(np.array(jax.random.normal(k2, x.shape, jnp.float32)))
    tx = torch.from_numpy(x)
    got = A.jitter_from_noise(A.time_warp_from_offsets(tx, offsets, tw), noise, js) if enabled else tx
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_warp_atol(x))
    a, b = (A.augment_imu(tx, cfg, torch.Generator().manual_seed(9)) for _ in range(2))
    assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(9)
    offsets = torch.randn((x.shape[0], A.KNOTS), generator=gen)
    noise = torch.randn(x.shape, generator=gen)
    expected = A.jitter_from_noise(A.time_warp_from_offsets(tx, offsets, tw), noise, js) if enabled else tx
    assert torch.equal(a, expected)


def _kept_share_within_3_sigma(mask: torch.Tensor, rate: float) -> None:
    n = mask.numel()
    keep = 1.0 - rate
    share = mask.float().mean().item()
    assert abs(share - keep) <= 3 * (keep * (1 - keep) / n) ** 0.5, (share, keep, n)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_masks(rate):
    """``layers.dropout``: the same generator seed gives the same mask, another seed
    another; the kept share is within 3σ of 1 − rate; kept elements are scaled by
    1/(1 − rate)."""
    x = torch.ones(64, 256)
    a, b = (dropout(x, rate, torch.Generator().manual_seed(1)) for _ in range(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, rate, torch.Generator().manual_seed(2)))
    _kept_share_within_3_sigma(a != 0, rate)
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1.0 / (1.0 - rate)), rtol=0, atol=0)


def test_classifier_head_dropout_only_in_train_mode():
    """``ClassifierHead(dropout=0.3)``: eval ignores dropout; train with a seeded generator
    is reproducible and drops ~30% of each hidden activation after its ReLU."""
    torch.manual_seed(0)
    head = ClassifierHead(16, [64, 32], 4, dropout=0.3, norm="layer")
    x = torch.randn(128, 16)
    rate0 = ClassifierHead(16, [64, 32], 4, dropout=0.0, norm="layer")
    rate0.load_state_dict(head.state_dict())
    assert torch.equal(head(x), rate0(x))
    assert torch.equal(rate0(x, train=True, generator=torch.Generator().manual_seed(3)), rate0(x))
    assert torch.equal(*(head(x, train=True, generator=torch.Generator().manual_seed(4)) for _ in range(2)))
    assert not torch.equal(head(x, train=True, generator=torch.Generator().manual_seed(4)), head(x))
    # the masks after each ReLU: its zeros beyond the ReLU's own
    hidden = []
    handles = [getattr(head, f"ln{i}").register_forward_hook(lambda m, i, o: hidden.append(torch.relu(o)))
               for i in range(2)]
    seen = []
    original = dropout

    def spy(t, rate, generator=None, shape=None):
        out = original(t, rate, generator, shape)
        seen.append((t, out))
        return out

    import tpuhar_torch.models.layers as layers_module

    layers_module.dropout = spy
    try:
        head(x, train=True, generator=torch.Generator().manual_seed(5))
    finally:
        layers_module.dropout = original
        for h in handles:
            h.remove()
    assert len(seen) == 2
    for (t, out), h in zip(seen, hidden):
        assert torch.equal(t, h)
        live = t != 0
        _kept_share_within_3_sigma(out[live] != 0, 0.3)


def test_cross_attention_dropout():
    """``CrossAttentionBlock(dropout=0.1)``: eval and rate 0 agree; train with a seeded
    generator is reproducible and differs from eval."""
    torch.manual_seed(1)
    block = CrossAttentionBlock(32, 4, 128, dropout=0.1)
    q, kv = torch.randn(2, 7, 32), torch.randn(2, 9, 32)
    plain = CrossAttentionBlock(32, 4, 128)
    plain.load_state_dict(block.state_dict())
    assert torch.equal(block(q, kv), plain(q, kv))
    assert torch.equal(plain(q, kv, train=True, generator=torch.Generator().manual_seed(0)), plain(q, kv))
    a, b = (block(q, kv, train=True, generator=torch.Generator().manual_seed(0)) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, block(q, kv))


def test_classification_schedule_matches_optax():
    from tpuhar.config import Config
    from tpuhar.train import optim as jopt

    cfg = Config()
    cfg.training.train_epochs = 3
    spe = 4
    for base in (1e-3, 1e-6):
        ours, theirs = optim.classification_schedule(base, cfg, spe), jopt.classification_schedule(base, cfg, spe)
        for count in (0, 1, 6, 12, 15):  # 0, 1, mid, end, past the end (held at the floor)
            np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=OPT_RTOL, err_msg=f"{base} {count}")
        assert ours(12) == pytest.approx(1e-7)


class _Classifier(torch.nn.Module):
    """Parameters under ``imu_encoder`` and ``classifier``, as the IMU classifier's."""

    def __init__(self, params):
        super().__init__()
        for group, leaves in params.items():
            sub = torch.nn.Module()
            for name, value in leaves.items():
                sub.register_parameter(name, torch.nn.Parameter(torch.from_numpy(value.copy())))
            self.add_module(group, sub)


@pytest.mark.parametrize("grad_scale", [10.0, 1e-3], ids=["clipped", "not_clipped"])
@pytest.mark.parametrize("mode", ["linear_probe", "finetune"])
def test_classification_optimizer_matches_optax(mode, grad_scale):
    """Three updates on seeded gradients against ``optax.chain(clip_by_global_norm,
    multi_transform({encoder, head}))``. The encoder's gradients are nonzero in the probe
    too: they count in the clip's norm, and the encoder does not move."""
    from tpuhar.config import Config
    from tpuhar.train import optim as jopt

    cfg = Config()
    cfg.training.train_epochs = 2
    rng = np.random.default_rng(0)
    shapes = {"imu_encoder": {"w": (3, 4), "b": (4,)}, "classifier": {"w": (4, 2), "b": (2,)}}
    params = {g: {k: rng.standard_normal(s).astype(np.float32) for k, s in leaves.items()} for g, leaves in shapes.items()}
    grads = [{g: {k: (rng.standard_normal(s) * grad_scale).astype(np.float32) for k, s in leaves.items()}
              for g, leaves in shapes.items()} for _ in range(3)]
    tx = jopt.make_classification_optimizer(cfg, 2, mode, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    model = _Classifier(params)
    opt = optim.make_classification_optimizer(cfg, 2, mode, model)
    for gs in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, gs), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in model.named_parameters():
            group, leaf = name.split(".")
            p.grad = torch.from_numpy(gs[group][leaf].copy())
        opt.step()
    assert opt.count == 3
    for name, p in model.named_parameters():
        group, leaf = name.split(".")
        want = np.asarray(jparams[group][leaf])
        if mode == "linear_probe" and group == "imu_encoder":
            assert np.array_equal(p.detach().numpy(), params[group][leaf]) and np.array_equal(want, params[group][leaf])
        else:
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=OPT_RTOL, err_msg=name)
    inner = state[1].inner_states  # multi_transform: each group's chain state
    for i, p in enumerate(opt.trained):
        name = next(n for n, q in model.named_parameters() if q is p)
        group, leaf = name.split(".")
        label = "encoder" if group == "imu_encoder" else "head"
        adam = inner[label].inner_state[0]
        np.testing.assert_allclose(opt.mu[i].numpy(), np.asarray(adam.mu[group][leaf]), rtol=OPT_RTOL, err_msg=name)
        np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[group][leaf]), rtol=OPT_RTOL, err_msg=name)
    assert len(opt.trained) == (2 if mode == "linear_probe" else 4)


def test_classification_optimizer_groups_and_modes():
    params = {"imu_encoder": {"w": np.ones((2, 2), np.float32)}, "classifier": {"w": np.ones(3, np.float32)}}
    model = _Classifier(params)
    from tpuhar_torch.config import Config

    groups = optim.classification_groups(model)
    assert [p.shape for p in groups["encoder"]] == [(2, 2)] and [p.shape for p in groups["head"]] == [(3,)]
    with pytest.raises(ValueError, match="Unknown classification mode"):
        optim.make_classification_optimizer(Config(), 1, "zero_shot", model)
