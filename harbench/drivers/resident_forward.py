"""``entry.build_forward`` on device-resident inputs: a pool of distinct request batches
made on the device from the seed, dispatched back to back with at most ``in_flight``
calls on the device. The unit is one window (a row of a batch). A seeded sample of the
calls' outputs is judged, every row of them, against the reference on the same inputs."""
from __future__ import annotations

from harbench import compare, driver, traffic, weights
from harbench.port import port_config
from harbench.reference.model import fusion_forward_blocks


class Driver:
    def __init__(self, ctx: driver.Context):
        self.ctx, self.w, self.cfg = ctx, ctx.workload, ctx.cfg
        self.cnn = ctx.cfg["tower"]["kind"] == "cnn"
        self.attempted = self.failed = 0

    def _inputs(self, k: int, wire: bool = True):
        g = self.ctx.generator(1, k)
        B = self.w["batch"]
        raw, clip = traffic.imu_counts(self.cfg, B, g), traffic.clips(self.cfg, B, g)
        if wire and self.cnn:
            clip = traffic.patch_major(clip, self.cfg["tower"]["patch"])
        return raw, clip

    def reference_inputs(self, k: int):
        """Batch ``k`` of the pool as the reference reads it: NHWC clips."""
        return self._inputs(k, wire=False)

    def make_weights(self) -> None:
        self.leaves = weights.fusion_model(self.cfg)
        self.flat = weights.make_flat(self.leaves, traffic.sub_seed(self.ctx.seed, 0), self.ctx.device)

    def setup(self) -> None:
        from tpuhar_torch import entry

        ctx = self.ctx
        pc = port_config(self.cfg, self.w["stage"])
        self.make_weights()
        tree = weights.as_tree(self.leaves, self.flat)
        fn, _ = entry.build_forward(pc, self.w["batch"], device=ctx.device, params=tree)
        if ctx.fault == "alter":
            fn = _altered(fn)
        self.fn = fn
        self.pool = [self._inputs(k) for k in range(self.w["pool"])]
        for _ in range(self.w["warmup_rounds"]):
            for args in self.pool:
                self.fn(*args)
        driver.synchronize(ctx.device)

    def window(self, seconds: float):
        self.keep = driver.Reservoir(self.w["keep"], traffic.sub_seed(self.ctx.seed, 2))
        pool = self.pool
        win = driver.pipelined(self.ctx.device, seconds, lambda i: self.fn(*pool[i % len(pool)]),
                               self.w["batch"], self.w["in_flight"], "model_step.forward", keep=self.keep)
        self.attempted = win.units
        return win

    def check(self):
        n = len(self.pool)
        kept = [(i % n, driver.as_host(out)) for i, out in self.keep.items]
        self.fn = self.pool = self.keep = None
        driver.release(self.ctx.device)
        tree = weights.as_tree(self.leaves, self.flat, to=self.ctx.device)
        gelu = "tanh" if self.ctx.stage["model"].get("gelu_approximate") else "none"
        refs = {}
        for k in sorted({k for k, _ in kept}):
            raw, clip = self.reference_inputs(k)
            refs[k] = driver.as_host(fusion_forward_blocks(self.cfg, tree, raw, clip, gelu=gelu,
                                                           block=self.w["reference_block"]))
        return compare.serving_gaps([(out, refs[k]) for k, out in kept])


def _altered(fn):
    """The fault of an answer altered where it is produced: one logit of each call
    moved by 0.5."""
    import torch

    def run(*args):
        out = dict(fn(*args))
        with torch.inference_mode():
            bump = torch.zeros_like(out["logits"])
            bump[0, 0] = 0.5
            out["logits"] = out["logits"] + bump
        return out

    return run
