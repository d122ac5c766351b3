"""The comparison that decides ``correct``: the numbers compared between what the timed
path produced and the reference, and the verdict against each number's limit.

Serving: over every compared window, the largest gap of the logits and of the fused
embedding, each as a share of the reference's largest magnitude. (The MSP and energy
scores, functions of the logits, are left out: the controls move them too little to
separate from rounding.)

Training: the gap of each step's loss as a share of the reference's; per parameter
leaf, the gap between the program's and the reference's norm of the first gradient as
the optimizer gets it, and of the change after the compared steps, each against the
reference's norm of that leaf or of the median leaf, whichever is larger, the worst
leaf counting; and the median leaf's gap of the first gradient, which a lower precision
moves on every seed where the worst leaf's is the rounding of one small leaf. Leaves
whose reference gradient is under a thousandth of the median leaf's (nought but
rounding, as a key bias under softmax) move under AdamW by round-off alone and are left
out of the change.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Mapping, Tuple

import torch

NEGLIGIBLE_GRAD = 1e-3  # a leaf's first gradient under this share of the median leaf's


def serving_gaps(pairs: Iterable[Tuple[Mapping[str, torch.Tensor], Mapping[str, torch.Tensor]]]) -> Dict[str, float]:
    """``pairs`` of (program's outputs, reference's outputs) for the same windows."""
    worst = {"logits_rel": 0.0, "embed_rel": 0.0}
    n = 0
    for got, ref in pairs:
        n += 1
        for key, out in (("logits", "logits_rel"), ("embeddings", "embed_rel")):
            g, r = torch.as_tensor(got[key]).double(), torch.as_tensor(ref[key]).double()
            if g.shape != r.shape:
                raise ValueError(f"{key}: the program's {tuple(g.shape)} against the reference's {tuple(r.shape)}")
            gap = float((g - r).abs().max()) / float(r.abs().max())
            worst[out] = max(worst[out], gap if math.isfinite(gap) else math.inf)
    if n == 0:
        raise ValueError("no outputs to compare")
    return worst


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float], leaves: List[str]) -> List[float]:
    """Each leaf's gap of norms against max(its reference norm, the median leaf's)."""
    median = statistics.median(ref[k] for k in leaves)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], median) for k in leaves]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def training_gaps(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{"loss": [..], "grad1": {leaf: norm}, "change": {leaf:
    norm}}`` over the same leaves and steps."""
    if set(prog["grad1"]) != set(ref["grad1"]):
        raise ValueError(f"leaves differ: {sorted(set(prog['grad1']) ^ set(ref['grad1']))[:8]}")
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("the program and the reference ran different numbers of steps")
    leaves = sorted(ref["grad1"])
    median = statistics.median(ref["grad1"][k] for k in leaves)
    moving = [k for k in leaves if ref["grad1"][k] >= NEGLIGIBLE_GRAD * median]
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    grad1 = leaf_gaps(prog["grad1"], ref["grad1"], leaves)
    return {
        "loss_rel": loss if math.isfinite(loss) else math.inf,
        "grad1_rel": max(grad1),
        "grad1_med": statistics.median(grad1),
        "change_rel": max(leaf_gaps(prog["change"], ref["change"], moving)),
    }


def worst_leaves(prog: Mapping, ref: Mapping, key: str, n: int = 5) -> List[List]:
    """The ``n`` leaves with the largest gaps of ``key`` ("grad1" or "change"), each as
    ``[leaf, gap, program's norm, reference's norm]``: where a gap comes from."""
    median = statistics.median(ref["grad1"].values() if key == "grad1" else ref[key].values())
    rows = [[k, abs(prog[key][k] - r) / max(r, median), prog[key][k], r] for k, r in ref[key].items()]
    return sorted(rows, key=lambda row: -row[1])[:n]


def judge(values: Mapping[str, float], limits: Mapping[str, float]) -> Tuple[bool, Dict[str, List[float]]]:
    """``correct`` (every number finite and within its limit) and ``{name: [value,
    limit]}`` in the limits' order."""
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f"no number for the limits {sorted(missing)}")
    table = {name: [float(values[name]), float(limit)] for name, limit in limits.items()}
    return all(math.isfinite(v) and v <= lim for v, lim in table.values()), table
