"""The readings a cell's limits are set from, in one process on the card:
``python3 -m harbench.control --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6
--seconds 2``.

For each seed of ``--seeds`` a sound run of the program (a short window, then the
comparison; in the training cell its first steps): the lower readings. For each of
``--control-seeds`` the control, the reference in fp8 against the reference in f32 (in
a serving cell on the cell's first pool batch, in the training cell over the same
first steps); in the training cell also the program with half of each batch left out,
and the program in f32 (a witness that the bf16 program's gaps are rounding). A step
that returns its state unchanged reads 1 on ``grad1_rel`` and ``change_rel`` by their
definition and is not run. Each reading is one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys

from harbench import compare, driver, run


def _driver(cell: str, seed: int, device, fault=None, dtype=None):
    """The cell's driver, not yet set up; ``dtype`` runs the program in another compute
    type (a witness, not a cell)."""
    from harbench import port

    w = port.load_json(run.HERE / "workloads" / f"{cell}.json")
    cfg = run.staged(port.config_file(w["config"]), w["stage"])
    if dtype is not None:
        cfg["dtype"] = cfg["model"]["compute_dtype"] = dtype
        cfg["stages"][w["stage"]]["model"]["compute_dtype"] = dtype
    module = run.load_module(run.HERE / "drivers" / f"{w['driver']}.py", f"harbench_control_{w['driver']}")
    return module.Driver(driver.Context(cfg, w, seed, device, fault=fault))


def fp8_serving(cell: str, seed: int, device) -> dict:
    """The reference in fp8 against the reference in f32 on the cell's first batch."""
    from harbench import weights
    from harbench.reference.model import fusion_forward_blocks

    drv = _driver(cell, seed, device)
    drv.make_weights()
    tree = weights.as_tree(drv.leaves, drv.flat, to=device)
    raw, clip = drv.reference_inputs(0)
    gelu = "tanh" if drv.cfg["model"].get("gelu_approximate") else "none"
    f32, fp8 = (driver.as_host(fusion_forward_blocks(drv.cfg, tree, raw, clip, gelu=gelu,
                                                     block=drv.w["reference_block"], precision=p))
                for p in ("f32", "fp8"))
    return compare.serving_gaps([(fp8, f32)])


def fp8_training(cell: str, seed: int, device) -> dict:
    """The reference's first steps in fp8 against its first steps in f32."""
    drv = _driver(cell, seed, device)
    drv.make_weights()
    return compare.training_gaps(drv.reference("fp8"), drv.reference("f32"))


def program_training(cell: str, seed: int, device, fault=None, dtype=None) -> dict:
    """The program's first steps against the reference's, with the worst leaves."""
    drv = _driver(cell, seed, device, fault, dtype)
    drv.setup()
    drv.task = drv.pool = drv.gen = None
    driver.release(device)
    ref = drv.reference()
    out = compare.training_gaps(drv.record, ref)
    out["loss"] = [drv.record["loss"], ref["loss"]]
    out["worst_grad1"] = compare.worst_leaves(drv.record, ref, "grad1")
    out["worst_change"] = compare.worst_leaves(drv.record, ref, "change")
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    run.cache_environment()
    device = torch.device("cuda")
    training = "pretrain" in args.workload

    def emit(kind, seed, values):
        print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed, "values": values}), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        if training:  # the first steps alone: the window plays no part in what is compared
            emit("program", seed, program_training(args.workload, seed, device))
            continue
        r = run.execute(args.workload, seed, args.seconds, False)
        emit("program", seed, {k: v for k, (v, _) in r["check"].items()})
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        if training:
            emit("control_fp8", seed, fp8_training(args.workload, seed, device))
            emit("fault_half", seed, program_training(args.workload, seed, device, fault="half"))
            emit("witness_f32", seed, program_training(args.workload, seed, device, dtype="float32"))
        else:
            emit("control_fp8", seed, fp8_serving(args.workload, seed, device))
        driver.release(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
