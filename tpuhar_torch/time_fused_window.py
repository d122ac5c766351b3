"""Time the fused window featurizer of several source trees in turns, on one CUDA device.

    python -m tpuhar_torch.time_fused_window parent=OTHER_ROOT change=.

Each ``name=ROOT`` names a tree that holds ``tpuhar_torch/``. Its package is imported
under a name of its own (``_tree_<name>``), so its ``featurize_windows_auto`` runs with
its own wrapper and its own kernel library, built from its ``csrc/``; its
``csrc/fused_window.cu`` is also compiled alone with ``-Xptxas -v``, and each kernel's
registers and spills are printed. On the same raw windows at the serving shape
``(B, 250, 6)`` for each ``B`` of ``BATCHES`` (k = 5, normalized: the serving path's),
each tree's output is held against the plain version (max abs diff) and against the
first tree's (bit for bit or not). Then every tree is timed in turns, in the order given
and back (``A B B A``), ``--rounds`` times, three ways, one after the other:

- ``host``: the wrapper's host time per call, a host clock around 1000 calls, read
  before the synchronize that follows them;
- ``graph``: a CUDA graph of 100 calls replayed 5 times between two CUDA events, ms per
  call: the device's pace with no host in the way;
- ``profiler``: the kernel's device time per launch, under ``torch.profiler`` over 50
  calls (the device ops whose names hold ``fused_window``).

At ``B = 8192`` a call moves 98 MB, more than the 50 MB L2, so the device reads device
memory there. The first line is the card's name and power limit as ``nvidia-smi`` gives
them; the last is a JSON object of every turn's times. Without a CUDA device it raises.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from . import _ext
from .ops.featurize import featurize_windows
from .profile_step import device_profile
from .utils.roofline import HBM_BYTES_PER_S

BATCHES = (8, 256, 8192)
T = 250


def profiler_ms(fn: Callable[[], object], calls: int = 50) -> float:
    """Device time per call of the kernels named ``fused_window*``, under the profiler."""
    fn()
    torch.cuda.synchronize()
    rows = device_profile(fn, (), calls)["rows"]
    return sum(r["ms"] for r in rows if "fused_window" in r["name"])


def graph_ms(fn: Callable[[], object], calls: int = 100, replays: int = 5) -> float:
    """ms per call of a CUDA graph that captures ``calls`` calls, replayed ``replays``
    times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_ms(fn: Callable[[], object], calls: int = 1000) -> float:
    """Host time per call: a host clock around ``calls`` calls, read before the
    synchronize that follows them."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def load_tree(name: str, root: Path):
    """The ``ops.fused_window`` module of the ``tpuhar_torch`` package under ``root``,
    imported as ``_tree_<name>``."""
    init = root.resolve() / "tpuhar_torch" / "__init__.py"
    package = f"_tree_{name}"
    spec = importlib.util.spec_from_file_location(package, init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[package] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{package}.ops.fused_window")


def ptxas_report(name: str, source: Path) -> None:
    """Compile ``source`` alone with ``-Xptxas -v``; print each kernel's registers and spills."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_ext.nvcc(), *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(Path(tmp) / "fw.o"), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
            print(f"[ptxas {name}] {kernel}: " + " | ".join(l.split(":", 1)[-1].strip() for l in lines[i + 1:i + 4]))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="name=root of a tree holding tpuhar_torch/")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_fused_window needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    trees = {}
    for spec in args.trees:
        name, _, root = spec.partition("=")
        ptxas_report(name, Path(root) / "tpuhar_torch" / "csrc" / "fused_window.cu")
        trees[name] = load_tree(name, Path(root))
        t0 = time.perf_counter()
        trees[name]._ext.library()
        print(f"[build {name}] {trees[name]._ext.library_path().name}: {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    raws = {b: torch.from_numpy(rng.normal(0, 8000, (b, T, 6)).astype(np.float32)).cuda() for b in BATCHES}
    for b, raw in raws.items():
        want, first = featurize_windows(raw), None
        for name, fw in trees.items():
            got = fw.featurize_windows_auto(raw)
            err = (got - want).abs().max().item()
            same = "" if first is None else f", bit for bit as the first tree: {torch.equal(got, first)}"
            first = got if first is None else first
            print(f"[check {name}] ({b}, {T}, 6): max abs diff to the plain version {err:.3e}{same}")

    # the host times first, before any profiler session is opened in the process
    measures = {"host": host_ms, "graph": graph_ms, "profiler": profiler_ms}
    times = {m: {b: {name: [] for name in trees} for b in BATCHES} for m in measures}
    order = list(trees)
    for m, measure in measures.items():
        for _ in range(args.rounds):
            for b, raw in raws.items():
                bound_us = 2 * raw.numel() * 4 / HBM_BYTES_PER_S * 1e6  # f32 in and out
                for name in order + order[::-1]:
                    t = measure(lambda: trees[name].featurize_windows_auto(raw))
                    times[m][b][name].append(t)
                    print(f"[time] {m} ({b}, {T}, 6) {name}: {t * 1e3:.3f} us (byte bound {bound_us:.3f} us)")
    print(json.dumps({"shape": [None, T, 6], "ms": times}))


if __name__ == "__main__":
    main()
