"""``BENCHMARK.json`` held to the benchmark's contract, and to the files it names:
``validate(root)`` returns the list of what is wrong (empty when all is well)."""
from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# a key that names a width may never be cut
WIDTH = re.compile(
    r"(hidden|intermediate|latent|state|projection|head|expansion|experts_per_tok|_dim$|_rank$|d_model|width|mlp)")


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def check_budget(run_seconds: int, cells: int = 24) -> bool:
    """A full check of ``cells`` cells fits its 43,200 seconds."""
    runs = 2 + 14 * cells
    return runs * (run_seconds + 60) + cells * 2 * 90 + 1200 <= 43200


def validate(root: Path) -> List[str]:
    root = Path(root)
    errors: List[str] = []
    raw = (root / "BENCHMARK.json").read_bytes()
    if len(raw) > 64 * 1024:
        errors.append("BENCHMARK.json is over 64 KiB")
    b = json.loads(raw)
    if set(b) != KEYS:
        errors.append(f"keys {sorted(set(b) ^ KEYS)} differ from the contract's")
        return errors
    paths = b["paths"]
    if not (1 <= len(paths) <= 16) or not all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in paths):
        errors.append(f"bad paths {paths}")
    cmd = b["command"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        errors.append("bad command")
    if not (isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51 and check_budget(b["run_seconds"])):
        errors.append(f"run_seconds {b['run_seconds']}")

    def under_paths(f: str) -> bool:
        return any(f == p or f.startswith(p.rstrip("/") + "/") for p in paths)

    names = set()
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[section]:
            if not NAME.match(str(e.get("name", ""))):
                errors.append(f"{section}: bad name {e.get('name')!r}")
            if e.get("name") in names:
                errors.append(f"name {e['name']} used twice")
            names.add(e.get("name"))

    configs = {c["name"]: c for c in b["configs"]}
    if not 1 <= len(configs) <= 24:
        errors.append("1 to 24 configurations")
    files = set()
    for c in b["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            errors.append(f"config {c['name']}: keys {sorted(c)}")
        if not (_line(c["source"]) and _line(c["why"])):
            errors.append(f"config {c['name']}: source or why")
        if not under_paths(c["file"]) or not (root / c["file"]).is_file() or c["file"] in files:
            errors.append(f"config {c['name']}: file {c['file']}")
        files.add(c["file"])
        if len(c["reduced"]) > 16 or any(not NAME.match(k) or WIDTH.search(k) for k in c["reduced"]):
            errors.append(f"config {c['name']}: reduced {c['reduced']}")
        if (root / c["file"]).is_file():
            body = json.loads((root / c["file"]).read_text())
            if body.get("name") != c["name"] or body.get("reduced") != c["reduced"] or body.get("source") != c["source"]:
                errors.append(f"config {c['name']}: the file's name, source or reduced differ from BENCHMARK.json's")

    cells = {w["name"]: w for w in b["workloads"]}
    if not 1 <= len(cells) <= 24:
        errors.append("1 to 24 cells")
    pairs = set()
    for w in b["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            errors.append(f"cell {w['name']}: keys {sorted(w)}")
        if w["config"] not in configs or w["chips"] not in (1, 4) or not _line(w["why"]):
            errors.append(f"cell {w['name']}: config, chips or why")
        if not NAME.match(w["traffic"]) or (w["config"], w["traffic"]) in pairs:
            errors.append(f"cell {w['name']}: traffic {w['traffic']}")
        pairs.add((w["config"], w["traffic"]))
        spec = root / "harbench" / "workloads" / f"{w['name']}.json"
        if not spec.is_file():
            errors.append(f"cell {w['name']}: no {spec.name}")
        else:
            body = json.loads(spec.read_text())
            drv = root / "harbench" / "drivers" / f"{body.get('driver')}.py"
            if body.get("config") != w["config"] or not drv.is_file():
                errors.append(f"cell {w['name']}: its file's config or driver")
            if not body.get("limits") or not all(isinstance(v, (int, float)) and v >= 0 for v in body["limits"].values()):
                errors.append(f"cell {w['name']}: limits")
    if sum(w["chips"] == 4 for w in b["workloads"]) > max(1, len(cells) // 4):
        errors.append("too many four-chip cells")
    if set(configs) - {w["config"] for w in b["workloads"]}:
        errors.append("a configuration without a cell")

    e2e = {m["name"]: m for m in b["end_to_end"]}
    if "setup_s" not in e2e or not 1 <= len(e2e) <= 16:
        errors.append("end_to_end needs setup_s and at most 16 metrics")
    for m in b["end_to_end"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "bound", "source"}:
            errors.append(f"{m['name']}: keys {sorted(m)}")
        if m["source"] not in ("host_clock", "device_trace") or m["better"] not in ("lower", "higher"):
            errors.append(f"{m['name']}: source or better")
        if not UNIT.match(m["unit"]):
            errors.append(f"{m['name']}: unit {m['unit']!r}")
        if not (0.01 <= m["bound"] <= 0.25 and math.isfinite(m["bound"])):
            errors.append(f"{m['name']}: bound {m['bound']}")
        if any(c not in cells for c in m.get("workloads", [])):
            errors.append(f"{m['name']}: a cell it lists does not exist")

    def reports(cell):
        return {n for n, m in e2e.items() if cell in m.get("workloads", cells)}

    if not 1 <= len(b["per_layer"]) <= 128:
        errors.append("1 to 128 per-layer metrics")
    layer_of_cell = {c: 0 for c in cells}
    for m in b["per_layer"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "source", "layer", "moves"}:
            errors.append(f"{m['name']}: keys {sorted(m)}")
        if m["source"] not in SOURCES or m["better"] not in ("lower", "higher") or not UNIT.match(m["unit"]):
            errors.append(f"{m['name']}: source, better or unit")
        if not _line(m["layer"]) or m["moves"] not in e2e or m["moves"] == "setup_s":
            errors.append(f"{m['name']}: layer or moves")
        listed = m.get("workloads", [c for c in cells if m["moves"] in reports(c)])
        for c in listed:
            if c not in cells:
                errors.append(f"{m['name']}: no cell {c}")
            elif m["moves"] not in reports(c):
                errors.append(f"{m['name']}: {c} does not report {m['moves']}")
            else:
                layer_of_cell[c] += 1
        if m["name"].split(".")[0].endswith("_roofline") and m["unit"] != "%":
            errors.append(f"{m['name']}: a roofline share is in %")
    for m in [*b["end_to_end"], *b["per_layer"]]:
        if not (root / "harbench" / "metrics" / f"{m['name']}.py").is_file():
            errors.append(f"{m['name']}: no reader")
    for c in cells:
        if "setup_s" not in reports(c) or len(reports(c)) < 2 or layer_of_cell[c] < 1:
            errors.append(f"cell {c}: needs setup_s, another end-to-end metric and a per-layer metric")
    return errors
