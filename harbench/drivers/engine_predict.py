"""``serving.InferenceEngine.predict`` from one client in a closed loop: each request is
a batch of host numpy arrays (raw counts and NHWC uint8 clips) from a pool made at
set-up from the seed; the next is sent when the previous one's outputs are on the host.
The unit is one window; every request's latency counts, and every answer of the window
is judged against the reference on its request."""
from __future__ import annotations

import time

from harbench import compare, driver, timeline, traffic, weights
from harbench.port import port_config
from harbench.reference.model import fusion_forward_blocks
from harbench.trace import span


class Driver:
    def __init__(self, ctx: driver.Context):
        self.ctx, self.w, self.cfg = ctx, ctx.workload, ctx.cfg
        self.attempted = self.failed = 0

    def reference_inputs(self, k: int):
        """Request ``k`` of the pool: raw counts and NHWC uint8 clips, on the device."""
        g = self.ctx.generator(1, k)
        B = self.w["batch"]
        return traffic.imu_counts(self.cfg, B, g), traffic.clips(self.cfg, B, g)

    def make_weights(self) -> None:
        self.leaves = weights.fusion_model(self.cfg)
        self.flat = weights.make_flat(self.leaves, traffic.sub_seed(self.ctx.seed, 0), self.ctx.device)

    def setup(self) -> None:
        from tpuhar_torch.serving import InferenceEngine

        ctx = self.ctx
        pc = port_config(self.cfg, self.w["stage"])
        self.make_weights()
        self.engine = InferenceEngine(pc, weights.as_tree(self.leaves, self.flat), **self.w["engine"],
                                      batch_sizes=[self.w["batch"]], device=ctx.device)
        self.pool = [tuple(t.cpu().numpy() for t in self.reference_inputs(k)) for k in range(self.w["pool"])]
        self.predict = self.engine.predict if ctx.fault != "alter" else _altered(self.engine.predict)
        self.engine.warmup()
        for _ in range(self.w["warmup_rounds"]):
            for args in self.pool:
                self.predict(*args)

    def window(self, seconds: float):
        self.kept = []
        n, B = len(self.pool), self.w["batch"]
        win = timeline.Window(start=time.perf_counter())
        deadline = win.start + seconds
        i = 0
        with span("window"):
            while True:
                issued = time.perf_counter()
                if issued >= deadline:
                    break
                with span("serving_engine.predict"):
                    out = self.predict(*self.pool[i % n])
                win.add(issued, time.perf_counter(), B)
                self.kept.append((i % n, out))
                i += 1
        self.attempted = win.units
        return win

    def check(self):
        kept = [(k, driver.as_host(out)) for k, out in self.kept]
        self.engine = self.predict = self.kept = None
        driver.release(self.ctx.device)
        tree = weights.as_tree(self.leaves, self.flat, to=self.ctx.device)
        gelu = "tanh" if self.w["engine"].get("fast_gelu") else "none"
        refs = {}
        for k in sorted({k for k, _ in kept}):
            raw, clip = self.reference_inputs(k)
            refs[k] = driver.as_host(fusion_forward_blocks(self.cfg, tree, raw, clip, gelu=gelu,
                                                           block=self.w["reference_block"]))
        return compare.serving_gaps([(out, refs[k]) for k, out in kept])


def _altered(predict):
    """The fault of an answer altered where it is produced: one logit of each request
    moved by 0.5."""

    def run(*args):
        out = predict(*args)
        out["logits"] = out["logits"].copy()
        out["logits"][0, 0] += 0.5
        return out

    return run
