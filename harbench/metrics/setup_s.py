"""Seconds from the process's start to the first timed call: imports, weights, inputs,
the kernels' build where the checkout has none, warm-up (host clock)."""


def read(run):
    return run.setup_s
