"""The benchmark's side of the system under test: the port's configuration built from a
configuration file, and the names of the program's parameters in the weight tree's
layout. Only the drivers import this module; the reference never does."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping

import torch

ROOT = Path(__file__).resolve().parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def config_file(name: str) -> Dict:
    return load_json(ROOT / "configs" / f"{name}.json")


def port_config(cfg: Mapping, stage: str):
    """The port's ``Config`` for ``stage`` of the configuration file ``cfg``: the entry
    point the file names (``entry.flagship_config``, ``vit_config``,
    ``pretrain_config``), then every field the file gives, the stage's over the
    file's. The tower's widths, which the port takes from its table by the backbone's
    name, must be the file's."""
    from tpuhar_torch import entry
    from tpuhar_torch.models.video import CNN_FEATURE_DIMS, TPU_CNN_CONFIGS, VIT_CONFIGS

    st = cfg["stages"][stage]
    pc = getattr(entry, st["entry"])(*st["args"])
    pc.model.compute_dtype = cfg["dtype"]
    for section in ("data", "model", "training"):
        fields = {**cfg.get(section, {}), **st.get(section, {})}
        for key, value in fields.items():
            if not hasattr(getattr(pc, section), key):
                raise KeyError(f"the port's config has no {section}.{key}")
            setattr(getattr(pc, section), key, tuple(value) if key == "video_resize" else value)
    pc.ood.energy_temperature = cfg["ood"]["energy_temperature"]
    t, bb = cfg["tower"], pc.model.video_backbone
    if t["kind"] == "cnn":
        widths, blocks = TPU_CNN_CONFIGS[bb]
        found = {"widths": list(widths), "blocks_per_stage": blocks, "feature_dim": CNN_FEATURE_DIMS[bb]}
    else:
        depth, width, heads = VIT_CONFIGS[bb]
        found = {"depth": depth, "d_model": width, "heads": heads, "mlp": 4 * width}
    wrong = {k: (v, t[k]) for k, v in found.items() if t[k] != v}
    if wrong:
        raise ValueError(f"the port's {bb} is not the file's tower: {wrong}")
    return pc


def flax_names(model: torch.nn.Module) -> Dict[str, str]:
    """``{torch parameter name: "a/b/kernel"}``: a Linear's weight is a kernel and a
    LayerNorm's weight a scale, as in the weight tree."""
    out = {}
    for path, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            leaf = name
            if isinstance(mod, torch.nn.Linear) and name == "weight":
                leaf = "kernel"
            elif isinstance(mod, torch.nn.LayerNorm) and name == "weight":
                leaf = "scale"
            out[f"{path}.{name}" if path else name] = "/".join([*path.split("."), leaf] if path else [leaf])
    return out
