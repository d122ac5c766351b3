"""``entry.build_pretrain_task``'s ``train_step`` on a device-resident pool of batches
(featurized IMU windows and uint8 clips) made from the seed, dropout drawn from a
generator on the device seeded from it. Set-up drives the task through its first
``check_steps`` steps, on distinct batches through the window's own call, reading each
step's loss, each leaf's first gradient as AdamW holds it after one step (its first
moment over 1 − β1) and each leaf's change after the last of them; the same task then
takes ``warmup_rounds`` more steps and runs the window, at most ``in_flight`` steps on
the device. The unit is one sample.
The reference repeats those first steps from the same weights, batches and masks."""
from __future__ import annotations

import torch

from harbench import compare, driver, traffic, weights
from harbench.port import flax_names, port_config
from harbench.reference.train import pretrain_steps


class Driver:
    def __init__(self, ctx: driver.Context):
        self.ctx, self.w, self.cfg = ctx, ctx.workload, ctx.cfg
        self.attempted = self.failed = 0

    def _batch(self, k: int):
        g = self.ctx.generator(1, k)
        B = self.w["batch"]
        return {"imu": traffic.featurized_imu(self.cfg, B, g), "video": traffic.clips(self.cfg, B, g)}

    def _step(self, i: int):
        batch = self.pool[i % len(self.pool)]
        if self.ctx.fault == "half":  # half of the batch left out, the mean over the rest
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        _, metrics = self.task.train_step(self.task.state, batch, self.gen)
        return metrics["loss"]

    def make_weights(self) -> None:
        self.leaves = weights.crossmodal_model(self.cfg, self.ctx.stage)
        self.flat = weights.make_flat(self.leaves, traffic.sub_seed(self.ctx.seed, 0), self.ctx.device)

    def setup(self) -> None:
        from tpuhar_torch import entry

        ctx, st = self.ctx, self.ctx.stage
        pc = port_config(self.cfg, self.w["stage"])
        self.make_weights()
        self.task = entry.build_pretrain_task(pc, device=ctx.device, params=weights.as_tree(self.leaves, self.flat),
                                              steps_per_epoch=st["steps_per_epoch"])
        if ctx.fault == "unchanged":  # a step that returns its state unchanged
            self.task.state.optimizer.step = lambda: None
        self.pool = [self._batch(k) for k in range(self.w["pool"])]
        self.gen = ctx.generator(4)
        model, opt = self.task.model, self.task.state.optimizer
        names = flax_names(model)
        named = list(model.named_parameters())
        start = [p.detach().clone() for _, p in named]
        losses, grad1 = [], {}
        for s in range(self.w["check_steps"]):
            losses.append(self._step(s))
            if s == 0:
                norms = torch.stack([torch.linalg.vector_norm(m) for m in opt.mu]) / (1.0 - st["adamw"]["b1"])
                grad1 = dict(zip((names[n] for n, _ in named), norms.tolist()))
        change = torch.stack([torch.linalg.vector_norm(p.detach() - p0) for (_, p), p0 in zip(named, start)])
        self.record = {"loss": [float(l) for l in losses], "grad1": grad1,
                       "change": dict(zip((names[n] for n, _ in named), change.tolist()))}
        del start
        for s in range(self.w["warmup_rounds"]):
            self._step(self.w["check_steps"] + s)
        self.first = self.w["check_steps"] + self.w["warmup_rounds"]
        driver.synchronize(ctx.device)

    def window(self, seconds: float):
        B = self.w["batch"]
        win = driver.pipelined(self.ctx.device, seconds, lambda i: self._step(self.first + i), B,
                               self.w["in_flight"], "model_step.train_step")
        self.attempted = win.units
        return win

    def check(self):
        self.task = self.pool = self.gen = None
        driver.release(self.ctx.device)
        return compare.training_gaps(self.record, self.reference())

    def reference(self, precision: str = "f32"):
        """The reference's record of the same first steps."""
        tree = weights.as_tree(self.leaves, self.flat, to=self.ctx.device)
        params = {"/".join(k): v for k, v in weights.flatten(tree["params"]).items()}
        batches = [self._batch(k) for k in range(self.w["check_steps"])]
        return pretrain_steps(self.cfg, self.ctx.stage, params, batches, self.ctx.generator(4), precision=precision)
