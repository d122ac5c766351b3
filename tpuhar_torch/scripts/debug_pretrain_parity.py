"""Card-against-CPU parity of the cross-modal pretraining step
(``scripts/debug_pretrain_parity.py``).

Everything but the device's arithmetic is held fixed: one process, the same
preprocessed pool, the same initial state, the same batches (captured once on the
host), the same dropout masks. Each arm then takes ``steps`` optimization steps from its
own copy of the initial state (the model, its BatchNorm statistics, AdamW's moments and
count are built afresh from the same flax-layout tree):

  cpu_f32       the steps on the CPU (the known-good arm)
  cuda_default  the steps on the card at PyTorch's defaults: full-f32 matmuls, TF32
                cuDNN convolutions
  cuda_f32ctx   the steps on the card with TF32 off for matmuls and convolutions
                (``precision_scope("float32")`` around the arm)
  cuda_highest  the same settings as a second run (``precision_scope("highest")``),
                the control for the order of the arms

Each records the global gradient norm of the InfoNCE loss at the initial state
(``train=False``, the first batch), the per-dimension spread of both projections
there, and the loss trajectory. Then two arms follow the pipeline's own path: the
initial state and the train generator drawn by ``Pipeline._next_key`` as
``run_pretraining`` draws them, the state built on the card or on the CPU and moved
(the port draws every initial tree on the host, so both start equal), each recording
the initial parameters' global norm. The arms' steps leave the matmul precision to the
arm, except the pipeline's, which keep ``pretrain_matmul_precision`` as the pipeline does.

Each step's dropout masks come from a CPU generator seeded from ``split_seeds(42,
steps)``, the same in every arm, where the JAX script splits ``PRNGKey(42)``. The arms
on the card are named ``cuda_*`` where the JAX script has ``tpu_*``.

Runs on the card unless ``--cpu`` (then ``cpu_f32`` alone), on an article run's pool
(``<workdir>/pool/out/preprocessed``); writes ``outputs/torch/docs/pretrain_parity.json``:
``python -m tpuhar_torch.scripts.debug_pretrain_parity [steps=40]
[workdir=outputs/torch/article_hard_r5] [--cpu]``
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
from pathlib import Path

import numpy as np
import torch

from ._common import log, script_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("steps", nargs="?", type=int, default=40)
    p.add_argument("workdir", nargs="?", default="outputs/torch/article_hard_r5")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def parity_config(pool: Path):
    """The JAX script's configuration of the pool: ``tiny_cnn`` at 32², 4 frames, f32,
    batch 64, lr 2e-4, seed 0."""
    from ..data.synthetic import make_synthetic_config

    cfg = make_synthetic_config(
        pool / "data", pool / "out",
        num_classes=6, video_backbone="tiny_cnn", video_resize=(32, 32),
        pretrain_epochs=30, pretrain_batch_size=64,
    )
    cfg.data.video_frames_per_window = 4
    cfg.model.compute_dtype = "float32"
    cfg.model.head_norm = "layer"
    cfg.training.pretrain_lr = 2e-4
    cfg.training.seed = 0
    return cfg


def capture_batches(loader, steps: int) -> list:
    """The loader's first ``steps`` batches as numpy, starting it again when it ends."""
    batches = []
    it = iter(loader)
    while len(batches) < steps:
        try:
            b = next(it)
        except StopIteration:
            if not batches:
                raise RuntimeError("the pool's train loader yields no batch")
            it = iter(loader)
            continue
        batches.append({k: np.asarray(v) for k, v in b.items()})
    return batches


def global_norm(tensors) -> float:
    return float(torch.sqrt(sum((t.float() ** 2).sum() for t in tensors)))


@contextlib.contextmanager
def torch_defaults():
    """PyTorch's own f32 settings inside the scope: full-f32 matmuls, TF32 cuDNN
    convolutions (whatever the caller set); restored after."""
    before = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]


def init_diagnostics(model, batch: dict, temperature: float):
    """The global norm of the InfoNCE loss's gradient at ``train=False`` and the mean
    per-dimension std (over the batch) of both projections, at the model's state."""
    from .. import losses as L
    from ..ops.video import normalize_clip

    params = list(model.parameters())
    out = model.forward_cast(batch["imu"], normalize_clip(batch["video"]), train=False)
    loss = L.infonce_loss(out["imu_proj"], out["video_proj"], temperature)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grad0 = global_norm(g for g in grads if g is not None)
    emb = {k: round(float(out[k].detach().float().std(0, correction=0).mean()), 6) for k in ("imu_proj", "video_proj")}
    return grad0, emb


def run_arm(cfg, params, steps_per_epoch: int, batches: list, seeds: list, device, scope):
    """``(losses, grad0, emb)`` of one arm: the steps on ``device`` inside ``scope``."""
    from ..data.loader import to_device
    from ..train.factory import build_crossmodal_task

    arm_cfg = copy.deepcopy(cfg)
    arm_cfg.training.pretrain_matmul_precision = "default"  # the arm's scope sets it
    with scope:
        task = build_crossmodal_task(arm_cfg, steps_per_epoch, params, device=device)
        losses, grad0, emb = [], None, None
        for i, b in enumerate(batches):
            db = to_device(b, device)
            if i == 0:
                grad0, emb = init_diagnostics(task.model, db, float(cfg.training.temperature))
            _, metrics = task.train_step(task.state, db, torch.Generator().manual_seed(seeds[i]))
            losses.append(float(metrics["loss"]))
    return losses, grad0, emb


def pipeline_faithful(cfg, steps_per_epoch: int, batches: list, device, init_on_cpu: bool):
    """``(losses, init_param_norm, {})``: the state and the train generator drawn by a
    fresh ``Pipeline``'s ``_next_key`` in ``run_pretraining``'s order, the state built on
    ``device`` or on the CPU and moved, the steps on ``device`` with the pipeline's one
    generator."""
    from ..bridge import init_params, variables_to_numpy
    from ..cli import Pipeline
    from ..data.loader import to_device
    from ..models.crossmodal import CrossModalModel
    from ..train.factory import build_crossmodal_task

    pipe = Pipeline(cfg, device=device)
    params = init_params(cfg, pipe._next_key(), CrossModalModel)
    k_train = pipe._next_key(device)
    if init_on_cpu:
        params = variables_to_numpy(build_crossmodal_task(cfg, steps_per_epoch, params, device="cpu").model)
    task = build_crossmodal_task(cfg, steps_per_epoch, params, device=device)
    pnorm = global_norm(p.detach() for p in task.model.parameters())
    losses = []
    for b in batches:
        _, metrics = task.train_step(task.state, to_device(b, device), k_train)
        losses.append(float(metrics["loss"]))
    return losses, pnorm, {}


def run(steps: int = 40, work="outputs/torch/article_hard_r5", *, device, params=None,
        out="outputs/torch/docs/pretrain_parity.json") -> dict:
    """The arms on the pool under ``work``; ``params`` is the initial flax-layout tree
    (default ``bridge.init_params`` from a CPU generator seeded 0). Writes and returns
    the JAX script's JSON."""
    from ..bridge import init_params
    from ..cli import Pipeline
    from ..data.loader import create_dataloaders
    from ..models.crossmodal import CrossModalModel
    from ..train.factory import split_seeds
    from ..train.steps import precision_scope

    device = torch.device(device)
    pool = Path(work) / "pool"
    if not (pool / "out" / "preprocessed").exists():
        raise FileNotFoundError(f"no pool at {pool}")
    cfg = parity_config(pool)
    pipe = Pipeline(cfg, device=device)
    train_df, val_df = pipe._metadata("train"), pipe._metadata("val")
    loaders = create_dataloaders(cfg, train_df, val_df, val_df, mode="cross_modal")
    batches = capture_batches(loaders["train"], steps)
    log(f"captured {len(batches)} batches (imu {batches[0]['imu'].shape}, video {batches[0]['video'].shape})")

    spe = len(loaders["train"])
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(0), CrossModalModel)
    seeds = split_seeds(torch.Generator().manual_seed(42), steps)
    arms = {"cpu_f32": run_arm(cfg, params, spe, batches, seeds, torch.device("cpu"), contextlib.nullcontext())}
    if device.type == "cuda":
        arms["cuda_default"] = run_arm(cfg, params, spe, batches, seeds, device, torch_defaults())
        arms["cuda_f32ctx"] = run_arm(cfg, params, spe, batches, seeds, device, precision_scope("float32"))
        arms["cuda_highest"] = run_arm(cfg, params, spe, batches, seeds, device, precision_scope("highest"))
        arms["cuda_pipe_faithful"] = pipeline_faithful(cfg, spe, batches, device, init_on_cpu=False)
        arms["cuda_pipe_keys_cpuinit"] = pipeline_faithful(cfg, spe, batches, device, init_on_cpu=True)

    record = {"bench": "pretrain_parity", "steps": steps, "arms": {}}
    for name, (losses, g0, emb) in arms.items():
        diag_key = "init_param_norm" if "pipe" in name else "grad_norm_step0"
        record["arms"][name] = {
            diag_key: round(g0, 6) if g0 is not None else None,
            "init_emb_std": emb,
            "loss_first5": [round(x, 4) for x in losses[:5]],
            "loss_last5": [round(x, 4) for x in losses[-5:]],
            "loss_final": round(losses[-1], 4),
        }
        log(f"{name}: grad0={g0} emb_std={emb} first5={losses[:5]} last={losses[-1]:.4f} losses={losses}")
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return record


def main(argv=None):
    args = parse_args(argv)
    return run(args.steps, args.workdir, device=script_device(args.cpu))


if __name__ == "__main__":
    main()
