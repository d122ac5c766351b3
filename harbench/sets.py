"""Runs of cells in one call, each a process of its own, one after another, and the
spread of their metrics: ``python3 -m harbench.sets --workload <cell> --seeds 1,2,3
--seconds 10 [--trace 1] [--out <dir>]``. Each run's result line and the end of its
standard error go to ``<out>/<cell>.<seed>.<trace>.json`` (``harbench_sets/`` unless
given); the summary gives each metric's median and the distance between its first and
third quartiles (``statistics.quantiles(values, n=4)``) as a share of the median."""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values):
    """(median, (Q3 − Q1) ÷ median)."""
    med = statistics.median(values)
    if len(values) < 2:
        return med, float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def run_one(cell: str, seed: int, seconds: float, trace: int, out: Path, timeout: float) -> dict:
    cmd = [sys.executable, "-m", "harbench.run", "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines:
        result = json.loads(lines[-1])
    record = {"cell": cell, "seed": seed, "trace": trace, "rc": proc.returncode, "wall_s": time.time() - t0,
              "result": result, "stderr_tail": proc.stderr[-3000:]}
    (out / f"{cell}.{seed}.{trace}.json").write_text(json.dumps(record))
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="harbench_sets")
    ap.add_argument("--timeout", type=float, default=1500)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    records = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        rec = run_one(args.workload, seed, args.seconds, args.trace, out, args.timeout)
        records.append(rec)
        r = rec["result"] or {}
        print(json.dumps({"seed": seed, "rc": rec["rc"], "wall_s": round(rec["wall_s"], 1),
                          "correct": r.get("correct"), "metrics": {k: v["value"] for k, v in r.get("metrics", {}).items()},
                          "check": r.get("check"), "peak": r.get("device", {}).get("memory_peak_bytes"),
                          "busy_s": r.get("device", {}).get("busy_s"), "window_s": r.get("device", {}).get("window_s")}),
              flush=True)
        if rec["rc"] != 0:
            print(rec["stderr_tail"], flush=True)
    ok = [r["result"] for r in records if r["result"]]
    for name in sorted({k for r in ok for k in r["metrics"]}):
        values = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
        med, sp = spread(values)
        print(f"{args.workload} {name}: n={len(values)} median={med!r} spread={sp!r} values={values}", flush=True)
    return 0 if len(ok) == len(records) else 1


if __name__ == "__main__":
    sys.exit(main())
