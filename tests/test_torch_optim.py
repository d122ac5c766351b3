"""The port's pretraining schedule and optimizer (``tpuhar_torch/train/optim.py``)
against the JAX package's optax recipe (``tpuhar/train/optim.py``).

The schedule at every step of a 3-epoch run, with and without warmup (the warmup=0
guard), rtol 1e-6 (optax evaluates it in f32). Three steps of
``make_pretrain_optimizer`` on a small random tree, with the global-norm clip engaged
(‖g‖ > 1) and not, against ``optax.chain(clip_by_global_norm, adamw)`` fed the same
gradients: parameters and both moments rtol 1e-6 (f32, the order of a few operations
differs).
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuhar.config import Config
from tpuhar.train import optim as jopt
from tpuhar_torch.train import optim

RTOL = 1e-6


def _config(warmup_epochs: int, epochs: int = 3):
    cfg = Config()
    cfg.training.pretrain_epochs = epochs
    cfg.training.pretrain_warmup_epochs = warmup_epochs
    return cfg


@pytest.mark.parametrize("warmup_epochs", [0, 1, 5], ids=["no_warmup", "warmup", "warmup_past_the_end"])
def test_schedule_matches_optax(warmup_epochs):
    cfg, spe = _config(warmup_epochs), 4
    ours, theirs = optim.pretrain_schedule(cfg, spe), jopt.pretrain_schedule(cfg, spe)
    for step in range(3 * spe + 2):  # past the end: the cosine holds at its floor
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=RTOL, err_msg=f"step {step}")
    if warmup_epochs:
        assert ours(0) == pytest.approx(0.1 * cfg.training.pretrain_lr)  # step 0 at 0.1·lr


@pytest.mark.parametrize("grad_scale", [10.0, 1e-3], ids=["clipped", "not_clipped"])
def test_optimizer_matches_optax(grad_scale):
    cfg = _config(1)
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (5,), "temperature": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in shapes.items()}
    grads = [{k: np.asarray(rng.standard_normal(s) * grad_scale, np.float32) for k, s in shapes.items()} for _ in range(3)]
    norms = [np.sqrt(sum(np.square(g).sum() for g in gs.values())) for gs in grads]
    assert all(n > 1.0 for n in norms) if grad_scale > 1 else all(n < 1.0 for n in norms)

    tx = jopt.make_pretrain_optimizer(cfg, 2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in shapes]
    opt = optim.make_pretrain_optimizer(cfg, 2, tparams)
    for gs in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in gs.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(tparams, shapes):
            p.grad = torch.from_numpy(gs[k].copy())
        opt.step()
    assert opt.count == 3
    adam = state[1][0]  # the chain's adamw: (ScaleByAdamState, ...)
    for i, k in enumerate(shapes):
        np.testing.assert_allclose(tparams[i].detach().numpy(), np.asarray(jparams[k]), rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(opt.mu[i].numpy(), np.asarray(adam.mu[k]), rtol=RTOL, err_msg=f"mu {k}")
        np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[k]), rtol=RTOL, err_msg=f"nu {k}")


def test_optimizer_state_round_trip():
    cfg = _config(1)
    params = [torch.nn.Parameter(torch.randn(4, 3)), torch.nn.Parameter(torch.randn(2))]
    opt = optim.make_pretrain_optimizer(cfg, 2, params)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    copy = optim.make_pretrain_optimizer(cfg, 2, [torch.nn.Parameter(p.detach().clone()) for p in params])
    copy.load_state_dict(opt.state_dict())
    assert copy.count == 1
    for a, b in zip(copy.mu + copy.nu, opt.mu + opt.nu):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        optim.make_pretrain_optimizer(cfg, 2, params[:1]).load_state_dict(opt.state_dict())
