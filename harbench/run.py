"""One run of one cell: ``python3 -m harbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout holding the port.

Set-up (process start to the first timed call: imports, weights, inputs, the kernels'
build on a checkout's first run, warm-up) is ``setup_s``. The run keeps to one CPU. The window then runs for
``--seconds`` and closes when the last work issued in it completes. With ``--trace 0``
the cell's end-to-end metrics are reported, with ``--trace 1`` its per-layer metrics,
each read by ``metrics/<name>.py``. After the window the program's state is freed and
the reference judges what the timed path produced: each number compared is printed
beside its limit, last on standard error and under ``"check"``, the last key of the
result, the JSON object on the last line of standard output.

No result is printed, and the exit code is not 0, when CUDA or the cell's cards are
missing, when the port is not in the checkout, when no work completed, or when the
JAX package or JAX itself was loaded into this process.
"""
from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Mapping, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuhar")


def cache_environment(root: Path = ROOT) -> None:
    """Every build and kernel cache of the program inside the checkout, at fixed paths."""
    cache = root / ".harbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv_compute")
    os.environ["USE_FLAX"] = "0"


def pin_to_one_core() -> None:
    """This process, and the threads it starts from now on, on the last CPU it may use,
    with one intra-op thread: the host-bound cells' pace then no longer moves with where
    the scheduler places the process (PERF.md §2)."""
    import torch

    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    torch.set_num_threads(1)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the JAX
    package's (``tpuhar``; ``tpuhar_torch`` is another name)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def staged(cfg: Mapping, stage: str) -> Dict:
    """The configuration as ``stage`` runs it: the stage's data, model and training
    fields over the file's."""
    st = cfg["stages"][stage]
    return {**cfg, **{k: {**cfg.get(k, {}), **st.get(k, {})} for k in ("data", "model", "training")}}


@dataclass
class Run:
    """What the metric readers read."""

    cfg: Mapping
    workload: Mapping
    window: object  # timeline.Window
    trace: object  # trace.Trace or None
    setup_s: float


def metric_specs(bench: Mapping, cell: str, traced: bool):
    """The cell's end-to-end metrics, or its per-layer ones: those that list it, or
    (without a list) every one whose end-to-end metric the cell reports."""
    def listed(m):
        return cell in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if (listed(m) if "workloads" in m else m["moves"] in names)]


def read_metrics(specs, run: Run, *, required: bool) -> Dict[str, Dict]:
    out = {}
    for spec in specs:
        module = load_module(HERE / "metrics" / f"{spec['name']}.py", "harbench_metric_" + spec["name"].replace(".", "_"))
        value = module.read(run)
        if value is None:
            if required:
                raise RuntimeError(f"{spec['name']}: nothing to read")
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"{spec['name']}: {value}")
        out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def power_limit() -> Optional[str]:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def execute(cell: str, seed: int, seconds: float, traced: bool, *, device=None, cfg=None, workload=None,
            fault: Optional[str] = None, process_start: float = PROCESS_START) -> Dict:
    """One run; returns the result object. ``device``, ``cfg`` and ``workload``
    override the cell's card and files (the tests run tiny configurations on the CPU)."""
    import torch

    from harbench import compare, driver, port
    from harbench.trace import traced as tracing

    bench = port.load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    workload = workload or port.load_json(HERE / "workloads" / f"{cell}.json")
    cfg = staged(cfg or port.config_file(entry["config"]), workload["stage"])
    device = torch.device(device or "cuda")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ctx = driver.Context(cfg, workload, seed, device, fault=fault)
    drv = load_module(HERE / "drivers" / f"{workload['driver']}.py", f"harbench_driver_{workload['driver']}").Driver(ctx)
    drv.setup()
    driver.synchronize(device)
    setup_s = time.time() - process_start
    window_s = min(seconds, workload.get("trace_seconds", seconds)) if traced else seconds
    with tracing(traced) as held:
        win = drv.window(window_s)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = Run(cfg, workload, win, held.trace, setup_s)
    metrics = read_metrics(metric_specs(bench, cell, traced), run, required=not traced)
    values = drv.check()
    correct, table = compare.judge(values, workload["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(drv.attempted), "failed": int(drv.failed),
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = held.trace.busy_s(), held.trace.window_s
        result["breakdown"] = {"device_ops": held.trace.device_ops(), "idle_gaps": held.trace.idle_gaps()}
    result["card"] = power_limit() if device.type == "cuda" else None
    result["check"] = table
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_environment()
    import torch

    chips = {w["name"]: w["chips"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
    if args.workload not in chips:
        print(f"harbench: no cell named {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[args.workload]:
        print(f"harbench: the cell needs {chips[args.workload]} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    pin_to_one_core()
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"harbench: modules of {found} were loaded into the run's process", file=sys.stderr)
        return 3
    for name, (value, limit) in result["check"].items():
        print(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
