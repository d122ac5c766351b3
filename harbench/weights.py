"""The cells' weights, made from ``--seed`` on the device in a few large calls.

The tree has the flax layout that the port's ``bridge.load_variables`` and the
reference both read: ``{"params": {...}, "batch_stats": {...}}`` nested by module name,
Dense kernels ``(in, out)``, attention projections ``(D, H, Dh)`` and ``(H, Dh, D)``,
HWIO conv kernels. Its leaves are listed here from the configuration file alone,
independent of the program. Kernels are drawn at fan-in scale; biases, norms and
BatchNorm statistics are drawn too (not left at 0 and 1), so that a program that drops
one of them shows.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch


class Leaf(NamedTuple):
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    kind: str  # kernel | bias | scale | shift | mean | var | unit | pos | const
    collection: str = "params"
    fan_in: int = 1
    value: float = 0.0


def _dense(p, d_in, d_out) -> List[Leaf]:
    return [Leaf(p + ("kernel",), (d_in, d_out), "kernel", fan_in=d_in), Leaf(p + ("bias",), (d_out,), "bias")]


def _ln(p, d) -> List[Leaf]:
    return [Leaf(p + ("scale",), (d,), "scale"), Leaf(p + ("bias",), (d,), "shift")]


def _bn(p, d) -> List[Leaf]:
    stats = [Leaf(p + (k,), (d,), k, "batch_stats") for k in ("mean", "var")]
    return _ln(p, d) + stats


def _attention(p, d, heads) -> List[Leaf]:
    dh = d // heads
    out = []
    for name in ("query", "key", "value"):
        out += [Leaf(p + (name, "kernel"), (d, heads, dh), "kernel", fan_in=d), Leaf(p + (name, "bias"), (heads, dh), "bias")]
    return out + [Leaf(p + ("out", "kernel"), (heads, dh, d), "kernel", fan_in=d), Leaf(p + ("out", "bias"), (d,), "bias")]


def imu_encoder(cfg: Mapping) -> List[Leaf]:
    m, data = cfg["model"], cfg["data"]
    C, P, d = data["imu_channels"], m["imu_patch_size"], m["imu_d_model"]
    n = (data["imu_window_size"] - P) // m["imu_stride"] + 1
    p = ("imu_encoder",)
    out = [Leaf(p + ("patch_embed", "kernel"), (C, P, d), "kernel", fan_in=P),
           Leaf(p + ("patch_embed", "bias"), (C, 1, d), "bias"),
           Leaf(p + ("cls_token",), (1, 1, d), "unit"), Leaf(p + ("pos_encoding",), (1, C * n + 1, d), "pos")]
    for i in range(m["imu_num_layers"]):
        b = p + (f"block{i}",)
        out += _attention(b + ("self_attn",), d, m["imu_nhead"]) + _ln(b + ("norm1",), d)
        out += _dense(b + ("linear1",), d, 4 * d) + _dense(b + ("linear2",), 4 * d, d) + _ln(b + ("norm2",), d)
    return out + _ln(p + ("final_norm",), d)


def video_encoder(cfg: Mapping) -> List[Leaf]:
    t, m = cfg["tower"], cfg["model"]
    p = ("video_encoder",)
    if t["kind"] == "cnn":
        b = p + ("backbone",)
        w, patch = t["widths"], t["patch"]
        out = [Leaf(b + ("stem_conv", "kernel"), (patch, patch, 3, w[0]), "kernel", fan_in=patch * patch * 3)]
        out += _bn(b + ("stem_bn",), w[0])
        prev = w[0]
        for si, c in enumerate(w):
            if si > 0:
                out += [Leaf(b + (f"down{si}_conv", "kernel"), (3, 3, prev, c), "kernel", fan_in=9 * prev)]
                out += _bn(b + (f"down{si}_bn",), c)
            for bi in range(t["blocks_per_stage"]):
                for part in "ab":
                    out += [Leaf(b + (f"s{si}b{bi}{part}_conv", "kernel"), (3, 3, c, c), "kernel", fan_in=9 * c)]
                    out += _bn(b + (f"s{si}b{bi}{part}_bn",), c)
            prev = c
        return out + _dense(p + ("projection",), t["feature_dim"], m["video_d_model"])
    d, v = t["d_model"], p + ("vit",)
    kt, kh, kw = t["tubelet"]
    n = (cfg["data"]["video_frames_per_window"] // kt) * (cfg["data"]["video_resize"][0] // kh) * (
        cfg["data"]["video_resize"][1] // kw)
    out = [Leaf(v + ("tubelet", "proj", "kernel"), (kt, kh, kw, 3, d), "kernel", fan_in=kt * kh * kw * 3),
           Leaf(v + ("tubelet", "proj", "bias"), (d,), "bias"), Leaf(v + ("pos_encoding",), (1, n, d), "pos")]
    for i in range(t["depth"]):
        b = v + (f"block{i}",)
        out += _ln(b + ("norm1",), d) + _attention(b + ("self_attn",), d, t["heads"]) + _ln(b + ("norm2",), d)
        out += _dense(b + ("mlp_in",), d, t["mlp"]) + _dense(b + ("mlp_out",), t["mlp"], d)
    if m.get("video_use_final_norm", True):
        out += _ln(v + ("final_norm",), d)
    return out + _dense(p + ("projection",), d, m["video_d_model"])


def classifier(cfg: Mapping, d_in: int) -> List[Leaf]:
    m = cfg["model"]
    out, prefix = [], "ln" if m["head_norm"] == "layer" else "bn"
    for i, h in enumerate(m["classifier_hidden_dims"]):
        out += _dense(("classifier", f"fc{i}"), d_in, h)
        out += (_ln if prefix == "ln" else _bn)(("classifier", f"{prefix}{i}"), h)
        d_in = h
    return out + _dense(("classifier", "out"), d_in, m["num_classes"])


def fusion_model(cfg: Mapping) -> List[Leaf]:
    """``FusionClassifier``: the serving model."""
    m = cfg["model"]
    d = m["imu_d_model"]
    out = imu_encoder(cfg) + video_encoder(cfg)
    out += _dense(("video_to_fusion",), m["video_d_model"], d) + _dense(("imu_to_fusion",), d, d)
    for i in range(m["fusion_layers"]):
        for stream in ("imu", "video"):
            b = (f"{stream}_xattn{i}",)
            out += _ln(b + ("norm_q",), d) + _ln(b + ("norm_kv",), d)
            out += _attention(b + ("cross_attn",), d, m["fusion_heads"]) + _ln(b + ("norm_mlp",), d)
            out += _dense(b + ("mlp_in",), d, 4 * d) + _dense(b + ("mlp_out",), 4 * d, d)
    return out + classifier(cfg, 2 * d)


def crossmodal_model(cfg: Mapping, stage: Mapping) -> List[Leaf]:
    """``CrossModalModel``: the pretraining model, with its projection heads and the
    SigLIP scalars at the configuration's initial values."""
    m = cfg["model"]
    out = imu_encoder(cfg) + video_encoder(cfg)
    for name, d_in in (("imu_proj", m["imu_d_model"]), ("video_proj", m["video_d_model"])):
        out += _dense((name, "fc1"), d_in, m["projection_hidden_dim"]) + _bn((name, "bn"), m["projection_hidden_dim"])
        out += _dense((name, "fc2"), m["projection_hidden_dim"], m["projection_dim"])
    init = stage["siglip_init"]
    return out + [Leaf(("temperature",), (), "const", value=init["temperature"]),
                  Leaf(("bias",), (), "const", value=init["bias"])]


# kind -> (multiplier of N(0, 1), offset); a kernel's multiplier is 1/sqrt(fan_in)
_DRAW = {"bias": (0.02, 0.0), "scale": (0.1, 1.0), "shift": (0.1, 0.0), "mean": (0.1, 0.0),
         "var": (0.2, 0.0), "unit": (1.0, 0.0), "pos": (0.02, 0.0), "const": (0.0, 0.0)}


def make_flat(leaves: List[Leaf], seed: int, device) -> np.ndarray:
    """Every leaf's values, concatenated in ``leaves``' order, as one f32 host array:
    one draw of N(0, 1) on ``device`` from ``seed``, scaled and shifted leaf by leaf in
    two broadcast calls, ``exp`` on the variances, one copy to the host."""
    sizes = [math.prod(l.shape) for l in leaves]
    mult = [1.0 / math.sqrt(l.fan_in) if l.kind == "kernel" else _DRAW[l.kind][0] for l in leaves]
    add = [l.value if l.kind == "const" else _DRAW.get(l.kind, (0, 0.0))[1] for l in leaves]
    g = torch.Generator(device=device).manual_seed(int(seed))
    counts = torch.tensor(sizes, device=device)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat = flat * torch.repeat_interleave(torch.tensor(mult, device=device), counts)
    flat = flat + torch.repeat_interleave(torch.tensor(add, device=device), counts)
    is_var = torch.repeat_interleave(torch.tensor([l.kind == "var" for l in leaves], device=device), counts)
    flat = torch.where(is_var, torch.exp(flat), flat)
    return flat.cpu().numpy()


def as_tree(leaves: List[Leaf], flat, *, to=None) -> Dict:
    """The flax-layout tree of views into ``flat`` (numpy, or a tensor with ``to`` a
    device, onto which ``flat`` is copied once)."""
    if to is not None:
        flat = torch.as_tensor(flat).to(to)
    tree: Dict = {"params": {}, "batch_stats": {}}
    start = 0
    for leaf in leaves:
        n = math.prod(leaf.shape)
        node = tree[leaf.collection]
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = flat[start:start + n].reshape(leaf.shape)
        start += n
    return tree


def flatten(tree: Mapping, prefix=()) -> Dict[Tuple[str, ...], object]:
    """``{path: leaf}`` of a nested tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out
