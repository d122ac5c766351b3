"""The port's parallel few-shot harness (``tpuhar_torch/eval/fewshot_parallel.py``)
against the JAX package's (``tpuhar/eval/fewshot_parallel.py``) and against the port's
own run-by-run harness (``eval/evaluator.FewShotEvaluator``), on the CPU.

- ``_sample_runs``, ``load_window_bank`` and ``PerRunEarlyStopper`` equal the JAX
  package's (the stopper also equals ``train.loop.EarlyStopper`` run by run).
- One batched step for R = 2 from the same stacked parameters as the JAX package's
  vmapped ``train_step`` (dropout off, so that the random streams cannot matter),
  with ``tests/test_torch_classify_steps.py``'s tolerances: each run's loss 1e-5
  relative, accuracy exactly, every gradient leaf within 1e-4 of its largest element
  plus 1e-5 of the largest gradient, the parameters after the step within 1e-6 +
  1e-4·lr where the gradients agree (at least 60% of them) and within Adam's 2·lr
  everywhere, BatchNorm statistics 1e-5.
- Per cell, the batched runs against the same runs trained one after the other
  through the same code (``run_ids=[r]``): each run's test confusion equal (f32).
- The batched harness's rows against the run-by-run harness's
  (``eval/evaluator.FewShotEvaluator``): the same schema and rows.
"""
import copy

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_classify_steps import (
    GRAD_AGREE,
    GRAD_FLOOR,
    GRAD_RTOL,
    LOSS_RTOL,
    NOISE_FACTOR,
    PARAM_ATOL,
    PARAM_RTOL_LR,
    STATS_ATOL,
    TIGHT_SHARE,
)
from test_torch_data import port_config

import jax
import jax.numpy as jnp

from tpuhar_torch.eval import fewshot_parallel as pf
from tpuhar_torch.train.optim import classification_schedule

torch.set_num_threads(2)


def _shrink(cfg):
    m = cfg.model
    m.imu_num_layers, m.imu_d_model, m.imu_nhead = 1, 32, 4
    m.classifier_hidden_dims, m.compute_dtype, m.head_norm = [16], "float32", "layer"
    cfg.training.train_epochs = 4
    cfg.training.train_lr_encoder = 1e-3
    cfg.eval.few_shot_samples, cfg.eval.few_shot_runs = [3], 2
    return cfg


@pytest.fixture(scope="module")
def prepared(synthetic_dataset, tmp_path_factory):
    from tpuhar.data.preprocess import Preprocessor
    from tpuhar.data.synthetic import make_synthetic_config

    jcfg = _shrink(make_synthetic_config(synthetic_dataset, tmp_path_factory.mktemp("fewshot") / "outputs"))
    dfs = {s: Preprocessor(jcfg).preprocess_split(s, save=True) for s in ("train", "val", "test")}
    return jcfg, dfs


def test_sample_runs_and_window_banks_match_jax(prepared):
    from tpuhar.eval.fewshot_parallel import _sample_runs, load_window_bank

    jcfg, dfs = prepared
    for k, runs in ((3, 2), (5, 4)):
        for mine, theirs in zip(pf._sample_runs(dfs["train"], k, runs), _sample_runs(dfs["train"], k, runs)):
            np.testing.assert_array_equal(mine, theirs)
    cfg = port_config(jcfg)
    for df in (dfs["val"], dfs["val"].drop(columns=["bank_idx"]), dfs["test"].head(5)):
        np.testing.assert_array_equal(pf.load_window_bank(df, cfg), load_window_bank(df, jcfg))


def test_per_run_stopper_matches_jax_and_the_sequential_stopper():
    from tpuhar.eval.fewshot_parallel import PerRunEarlyStopper
    from tpuhar_torch.train.loop import EarlyStopper

    values = np.random.default_rng(7).uniform(0, 100, size=(6, 30))
    values[:, 5:9] = 50.0  # ties must not count as improvements
    mine, theirs = pf.PerRunEarlyStopper(6, 3), PerRunEarlyStopper(6, 3)
    for e in range(30):
        np.testing.assert_array_equal(mine.update(values[:, e]), theirs.update(values[:, e]))
        np.testing.assert_array_equal(mine.active, theirs.active)
        assert mine.all_stopped == theirs.all_stopped
    for r in range(6):
        es = EarlyStopper(3, "max")
        for e in range(30):
            es.update(float(values[r, e]))
            if es.should_stop:
                break
        assert mine.best[r] == es.best


def _jax_stack(jcfg, mode, R, B):
    """JAX's vmapped classifier state for R runs and its jitted vmapped steps."""
    from tpuhar.models.crossmodal import IMUClassifier
    from tpuhar.train.optim import make_classification_optimizer
    from tpuhar.train.steps import TrainState, classification_step_fns

    model = IMUClassifier(jcfg, freeze_encoder=mode == "linear_probe")
    example = jnp.zeros((B, 6, 250), jnp.float32)

    def init_one(key):
        v = model.init(key, example)
        return v["params"], v.get("batch_stats", {})

    params, stats = jax.jit(jax.vmap(init_one))(jax.random.split(jax.random.PRNGKey(0), R))
    tx = make_classification_optimizer(jcfg, 1, mode, jax.tree_util.tree_map(lambda x: x[0], params))
    state = TrainState(step=jnp.zeros((R,), jnp.int32), params=params, batch_stats=stats,
                       opt_state=jax.vmap(tx.init)(params), tx=tx)
    train_fn, _ = classification_step_fns(model, jcfg)
    return model, state, jax.jit(jax.vmap(train_fn, in_axes=(0, 0, 0)))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _run_tree(runs: pf.BatchedRuns, r: int, grads=None):
    """Run ``r``'s parameters, statistics (and ``grads``) as flat flax-layout dicts,
    read through the stack's base module and ``bridge``."""
    from tpuhar_torch.bridge import grads_to_numpy, variables_to_numpy

    model = runs.base
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(runs.params[n][r])
            p.grad = None if grads is None else grads[n][r].clone()
        for n, b in model.named_buffers():
            b.copy_(runs.buffers[n][r])
    tree = variables_to_numpy(model)
    g = dict(_flat(grads_to_numpy(model))) if grads is not None else None
    return dict(_flat(tree["params"])), dict(_flat(tree["batch_stats"])), g


@pytest.mark.parametrize("mode,head_norm", [("linear_probe", "batch"), ("finetune", "layer"), ("finetune", "batch")])
def test_batched_step_matches_jax_vmapped_step(prepared, mode, head_norm):
    from tpuhar import losses as JL

    jcfg = copy.deepcopy(prepared[0])
    jcfg.model.head_norm = head_norm
    jcfg.model.imu_dropout = jcfg.model.classifier_dropout = 0.0
    cfg = port_config(jcfg)
    R, B = 2, 8
    jmodel, jstate, vtrain = _jax_stack(jcfg, mode, R, B)
    rng = np.random.default_rng(0)
    batch = {"imu": rng.standard_normal((R, B, 6, 250)).astype(np.float32),
             "label": rng.integers(0, 4, (R, B)).astype(np.int32), "n_valid": np.full((R,), B, np.int32)}
    trees = [jax.device_get(jax.tree_util.tree_map(lambda x: x[r], {"params": jstate.params, "batch_stats": jstate.batch_stats}))
             for r in range(R)]
    imu, label = torch.from_numpy(batch["imu"]), torch.from_numpy(batch["label"]).long()

    def jloss(params, stats, imu, label):
        (logits, _), _ = jmodel.apply({"params": params, "batch_stats": stats}, imu, train=True, mutable=["batch_stats"])
        return JL.cross_entropy_loss(logits, label)

    want_loss, want_grads = jax.jit(jax.vmap(jax.value_and_grad(jloss)))(jstate.params, jstate.batch_stats, batch["imu"], batch["label"])
    grad_runs = pf.BatchedRuns(cfg, mode, trees, device="cpu", steps_per_epoch=1)
    grads, loss, _ = grad_runs.gradients(imu, label)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), rtol=LOSS_RTOL)

    runs = pf.BatchedRuns(cfg, mode, trees, device="cpu", steps_per_epoch=1)
    out = runs.train_step(imu, label)
    jstate2, jout = vtrain(jstate, batch, jax.random.split(jax.random.PRNGKey(1), R))
    np.testing.assert_allclose(out["loss"].numpy(), np.asarray(jout["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(out["accuracy"].numpy(), np.asarray(jout["accuracy"]))
    lr = {g: classification_schedule(v, cfg, 1)(0) for g, v in (("encoder", cfg.training.train_lr_encoder),
                                                               ("head", cfg.training.train_lr_head))}
    tight = total = 0
    for r in range(R):
        g_want = dict(_flat(jax.device_get(jax.tree_util.tree_map(lambda x: x[r], want_grads))))
        gfloor = GRAD_FLOOR * max(np.abs(v).max() for v in g_want.values())
        _, _, g_port = _run_tree(grad_runs, r, grads)
        got_params, got_stats, _ = _run_tree(runs, r)
        assert g_port.keys() == g_want.keys()
        want_params = dict(_flat(jax.device_get(jax.tree_util.tree_map(lambda x: x[r], jstate2.params))))
        init = dict(_flat(trees[r]["params"]))
        for name, w in want_params.items():
            g = g_want[name]
            assert np.abs(g_port[name] - g).max() <= GRAD_RTOL * np.abs(g).max() + gfloor, (r, name)
            encoder = name.startswith("imu_encoder/")
            if mode == "linear_probe" and encoder:  # the frozen encoder: no gradient, no move
                assert not np.any(g) and not np.any(g_port[name]), name
                assert np.array_equal(got_params[name], init[name]) and np.array_equal(w, init[name]), name
                continue
            noisy = (np.abs(g) <= NOISE_FACTOR * gfloor) | (np.abs(g_port[name] - g) > GRAD_AGREE * np.abs(g))
            step_lr = lr["encoder" if encoder else "head"]
            err = np.abs(got_params[name] - w)
            assert np.all(err[~noisy] <= PARAM_ATOL + PARAM_RTOL_LR * step_lr), (r, name)
            assert np.all(err <= 2 * step_lr), (r, name)
            tight += int((~noisy).sum())
            total += w.size
        for name, w in _flat(jax.device_get(jax.tree_util.tree_map(lambda x: x[r], jstate2.batch_stats))):
            np.testing.assert_allclose(got_stats[name], w, rtol=0, atol=STATS_ATOL, err_msg=name)
    assert tight / total >= TIGHT_SHARE


@pytest.mark.parametrize("mode", ["linear_probe", "finetune"])
def test_parallel_matches_sequential_runs_per_cell(prepared, mode):
    """One cell's R = 2 runs in the stack, and the same runs trained one after the
    other through the same code (each its tree and its batch order, ``run_ids=[r]``):
    the same test confusion, run for run. Dropout off: the stack draws its runs' masks
    together, from one stream."""
    jcfg, dfs = prepared
    cfg = port_config(jcfg)
    cfg.model.imu_dropout = cfg.model.classifier_dropout = 0.0
    cfg.model.head_norm = "batch"
    cfg.training.train_epochs = 3
    train_bank = pf.load_window_bank(dfs["train"], cfg)
    fit_bank, fit_labels = pf.load_window_bank(dfs["val"], cfg), dfs["val"]["label"].to_numpy(np.int32)
    test_bank, test_labels = pf.load_window_bank(dfs["test"], cfg), dfs["test"]["label"].to_numpy(np.int32)
    idx, lab = pf._sample_runs(dfs["train"], 3, 2)
    trees = pf.init_run_trees(cfg, mode, None, 2, torch.Generator().manual_seed(0))
    evals = (fit_bank, fit_labels, test_bank, test_labels)
    together = pf.fewshot_cell(cfg, mode, trees, train_bank, idx, lab, *evals, device="cpu", generator=torch.Generator())
    assert together.sum() == 2 * len(test_labels)
    for r in range(2):
        alone = pf.fewshot_cell(cfg, mode, trees[r:r + 1], train_bank, idx[r:r + 1], lab[r:r + 1], *evals,
                                device="cpu", generator=torch.Generator(), run_ids=[r])
        np.testing.assert_array_equal(alone[0], together[r])


def test_parallel_rows_have_the_sequential_harness_schema(prepared):
    """Both harnesses on the same grid: the same columns and rows, and every metric a
    percentage. Their values are not compared: the two harnesses draw their initial
    trees, batch orders and dropout masks from different streams, and on this
    fixture a run's balanced accuracy moves by 10-30 points with them (the JAX
    package's own two harnesses gave 30.0 and 19.3 in one cell with ``PRNGKey(1)``),
    so the runs trained alone above are what the batched program is held to."""
    from tpuhar_torch.eval.evaluator import FewShotEvaluator

    jcfg, dfs = prepared
    cfg = port_config(jcfg)
    par = pf.run_parallel_fewshot(cfg, None, dfs["train"], dfs["test"], dfs["val"], experiment_name="x",
                                  generator=torch.Generator().manual_seed(0), verbose=False, device="cpu")
    seq = FewShotEvaluator(cfg, torch.Generator().manual_seed(0), device="cpu").run_few_shot_experiments(
        None, dfs["train"], dfs["test"], dfs["val"], experiment_name="x", verbose=False)
    assert isinstance(par, pd.DataFrame) and list(par.columns) == list(seq.columns)
    assert len(par) == len(seq) == 1 * 2 * 2
    key = ["experiment", "n_samples", "run", "mode"]
    assert sorted(map(tuple, par[key].values.tolist())) == sorted(map(tuple, seq[key].values.tolist()))
    for df in (par, seq):
        metrics = df.drop(columns=key).to_numpy()
        assert np.isfinite(metrics).all() and (metrics >= 0).all() and (metrics <= 100).all()
