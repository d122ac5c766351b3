"""Weights I/O (``tpuhar/models/convert.py``): torch state dicts of pretrained video
backbones → the flax-layout trees ``bridge.load_variables`` reads, and back.

A checkpoint on disk (HF ``pytorch_model.bin`` of a VideoMAE, a torchvision ``.pth`` of
ResNet-18 or MobileNetV2, or this package's own export) is read into a flat
name → array dict (``load_state_dict``), converted into the flax tree of the configured
backbone (``convert_video_backbone``), and grafted into a model's ``video_encoder``
subtree (``graft_model_video_weights``), which the task factories then load. Each
converter gives the same numpy tree the JAX package's converter gives, so the two can
be compared bit for bit; the ``export_*`` functions are their exact inverses
(``convert(export(params)) == params``).

Layouts:

- HF VideoMAE: the tubelet Conv3d ``(D, 3, t, k, k)``; per layer q/k/v ``(D, D)``
  out × in with **no key bias** (only ``q_bias``/``v_bias``); the ``intermediate``/
  ``output`` MLP; ``layernorm_before``/``after``; a fixed sinusoid position table that
  HF keeps out of most state dicts. A ``VideoMAEForVideoClassification`` checkpoint
  carries the same keys under ``videomae.``.
- torchvision ResNet-18 and MobileNetV2: ``(out, in, kh, kw)`` convs (HWIO here);
  BatchNorm affines go to ``params``, running statistics to ``batch_stats``; the
  classifier heads are dropped.

This module imports no JAX; torch is imported only to read and write ``.pt`` files.
"""
from __future__ import annotations

import difflib
from typing import Dict, Mapping

import numpy as np

from .video import VIT_CONFIGS


def sinusoid_position_table(n_positions: int, d_model: int) -> np.ndarray:
    """The fixed sin/cos table HF VideoMAE adds to the patch embeddings, ``(1, N, D)``."""
    position = np.arange(n_positions)[:, None]
    div = np.power(10000.0, 2 * (np.arange(d_model) // 2) / d_model)
    table = position / div
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table[None].astype(np.float32)


def _np(t) -> np.ndarray:
    """A torch tensor or array as float32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _is_vit(backbone: str) -> bool:
    return "/" in backbone or "videomae" in backbone.lower()


def _vit_shape(backbone: str):
    """``(depth, d_model, heads)`` of a ViT backbone name; any HF-style name is the base."""
    return VIT_CONFIGS[backbone if backbone in VIT_CONFIGS else "videomae_base"]


# ---------------------------------------------------------------------------------
# VideoMAE → VideoViT
# ---------------------------------------------------------------------------------
def _missing_key(key: str, sd: Mapping) -> KeyError:
    """A missing key named with the nearest keys the checkpoint has."""
    near = difflib.get_close_matches(key, [str(k) for k in sd], n=3, cutoff=0.4)
    return KeyError(
        f"checkpoint has no key {key!r} (nearest present: {near}); supported "
        "layouts: HF VideoMAEModel / VideoMAEForVideoClassification "
        "('videomae.'-prefixed), torchvision resnet18 / mobilenet_v2, and "
        "the export_* dicts of tpuhar_torch/models/convert.py"
    )


def convert_videomae_state_dict(sd: Mapping, depth: int, d_model: int, num_heads: int, n_positions: int) -> Dict:
    """HF ``VideoMAEModel.state_dict()`` (bare or ``videomae.``-prefixed; the
    classification head's keys are ignored) → the params of ``VideoViT``."""
    hd = d_model // num_heads

    def pre(key):
        if key in sd:
            return sd[key]
        if "videomae." + key in sd:
            return sd["videomae." + key]
        raise _missing_key(key, sd)

    def has(key):
        return key in sd or ("videomae." + key) in sd

    params: Dict = {}
    w = _np(pre("embeddings.patch_embeddings.projection.weight"))  # (D, 3, t, k, k)
    params["tubelet"] = {
        "proj": {
            "kernel": w.transpose(2, 3, 4, 1, 0),  # (t, k, k, 3, D)
            "bias": _np(pre("embeddings.patch_embeddings.projection.bias")),
        }
    }
    # HF keeps the sinusoid table out of the state dict; a checkpoint that carries it
    # (every export below, where the table is a trained parameter) wins
    if has("embeddings.position_embeddings"):
        params["pos_encoding"] = _np(pre("embeddings.position_embeddings")).reshape(1, n_positions, d_model)
    else:
        params["pos_encoding"] = sinusoid_position_table(n_positions, d_model)

    for i in range(depth):
        p = f"encoder.layer.{i}."
        a = p + "attention.attention."

        def qkv(name):
            return _np(pre(a + name + ".weight")).T.reshape(d_model, num_heads, hd)

        # VideoMAE has no key bias; an export carries a nonzero one as "k_bias"
        k_bias = (
            _np(pre(a + "k_bias")).reshape(num_heads, hd) if has(a + "k_bias")
            else np.zeros((num_heads, hd), np.float32)
        )
        params[f"block{i}"] = {
            "norm1": {"scale": _np(pre(p + "layernorm_before.weight")), "bias": _np(pre(p + "layernorm_before.bias"))},
            "self_attn": {
                "query": {"kernel": qkv("query"), "bias": _np(pre(a + "q_bias")).reshape(num_heads, hd)},
                "key": {"kernel": qkv("key"), "bias": k_bias},
                "value": {"kernel": qkv("value"), "bias": _np(pre(a + "v_bias")).reshape(num_heads, hd)},
                "out": {
                    "kernel": _np(pre(p + "attention.output.dense.weight")).T.reshape(num_heads, hd, d_model),
                    "bias": _np(pre(p + "attention.output.dense.bias")),
                },
            },
            "norm2": {"scale": _np(pre(p + "layernorm_after.weight")), "bias": _np(pre(p + "layernorm_after.bias"))},
            "mlp_in": {"kernel": _np(pre(p + "intermediate.dense.weight")).T, "bias": _np(pre(p + "intermediate.dense.bias"))},
            "mlp_out": {"kernel": _np(pre(p + "output.dense.weight")).T, "bias": _np(pre(p + "output.dense.bias"))},
        }
    # a checkpoint trained with mean pooling has no final LayerNorm: build the ViT
    # with use_final_norm=False for it
    if videomae_has_final_norm(sd):
        params["final_norm"] = {"scale": _np(pre("layernorm.weight")), "bias": _np(pre("layernorm.bias"))}
    return params


def videomae_has_final_norm(sd: Mapping) -> bool:
    return "layernorm.weight" in sd or "videomae.layernorm.weight" in sd


# ---------------------------------------------------------------------------------
# torchvision ResNet-18 and MobileNetV2 → ResNet18, MobileNetV2
# ---------------------------------------------------------------------------------
def _get(sd: Mapping, key: str):
    try:
        return sd[key]
    except KeyError:
        raise _missing_key(key, sd) from None


def _bn(sd: Mapping, prefix: str):
    return (
        {"scale": _np(_get(sd, prefix + ".weight")), "bias": _np(_get(sd, prefix + ".bias"))},
        {"mean": _np(_get(sd, prefix + ".running_mean")), "var": _np(_get(sd, prefix + ".running_var"))},
    )


def _conv(sd: Mapping, key: str) -> Dict:
    return {"kernel": _np(_get(sd, key)).transpose(2, 3, 1, 0)}  # (out, in, kh, kw) → HWIO


def convert_resnet18_state_dict(sd: Mapping):
    """torchvision ``resnet18().state_dict()`` → ``(params, batch_stats)`` of ``ResNet18``
    (the ``fc`` head dropped)."""
    params: Dict = {"stem_conv": _conv(sd, "conv1.weight")}
    batch_stats: Dict = {}
    params["stem_bn"], batch_stats["stem_bn"] = _bn(sd, "bn1")
    for li in range(4):
        for bi in range(2):
            tp, fp = f"layer{li + 1}.{bi}", f"layer{li}_{bi}"
            p: Dict = {"conv1": _conv(sd, f"{tp}.conv1.weight")}
            s: Dict = {}
            p["bn1"], s["bn1"] = _bn(sd, f"{tp}.bn1")
            p["conv2"] = _conv(sd, f"{tp}.conv2.weight")
            p["bn2"], s["bn2"] = _bn(sd, f"{tp}.bn2")
            if f"{tp}.downsample.0.weight" in sd:
                p["downsample_conv"] = _conv(sd, f"{tp}.downsample.0.weight")
                p["downsample_bn"], s["downsample_bn"] = _bn(sd, f"{tp}.downsample.1")
            params[fp], batch_stats[fp] = p, s
    return params, batch_stats


# features.0 is the stem ConvBNReLU, features.1..17 the inverted residuals (an expand
# ConvBNReLU where the ratio is not 1, the depthwise ConvBNReLU, the projection conv and
# its BatchNorm), features.18 the head ConvBNReLU
MOBILENET_V2_EXPAND = [1, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6]


def _mobilenet_layers(i: int):
    """``(torch prefix, flax conv, flax bn)`` of inverted residual ``i``'s three convs."""
    tp = f"features.{i + 1}.conv"
    if MOBILENET_V2_EXPAND[i] == 1:
        return [(f"{tp}.0.0", f"{tp}.0.1", "dw"), (f"{tp}.1", f"{tp}.2", "project")]
    return [(f"{tp}.0.0", f"{tp}.0.1", "expand"), (f"{tp}.1.0", f"{tp}.1.1", "dw"), (f"{tp}.2", f"{tp}.3", "project")]


def convert_mobilenet_v2_state_dict(sd: Mapping):
    """torchvision ``mobilenet_v2().state_dict()`` → ``(params, batch_stats)`` of
    ``MobileNetV2`` (``.features`` only; the classifier dropped)."""
    params: Dict = {"stem_conv": _conv(sd, "features.0.0.weight")}
    batch_stats: Dict = {}
    params["stem_bn"], batch_stats["stem_bn"] = _bn(sd, "features.0.1")
    for i in range(17):
        p: Dict = {}
        s: Dict = {}
        for conv_key, bn_key, name in _mobilenet_layers(i):
            p[f"{name}_conv"] = _conv(sd, conv_key + ".weight")
            p[f"{name}_bn"], s[f"{name}_bn"] = _bn(sd, bn_key)
        params[f"ir{i}"], batch_stats[f"ir{i}"] = p, s
    params["head_conv"] = _conv(sd, "features.18.0.weight")
    params["head_bn"], batch_stats["head_bn"] = _bn(sd, "features.18.1")
    return params, batch_stats


# ---------------------------------------------------------------------------------
# Export: flax trees → torch-layout state dicts (the converters' exact inverses)
# ---------------------------------------------------------------------------------
def export_videomae_state_dict(params: Mapping, depth: int, num_heads: int) -> Dict:
    """``VideoViT`` params → the HF ``VideoMAEModel.state_dict()`` layout, with two keys
    beyond HF's (both optional for ``convert``): ``embeddings.position_embeddings`` (the
    trained table) and a layer's ``attention.attention.k_bias`` where it is nonzero."""
    proj = params["tubelet"]["proj"]
    sd: Dict = {
        "embeddings.patch_embeddings.projection.weight": _np(proj["kernel"]).transpose(4, 3, 0, 1, 2),
        "embeddings.patch_embeddings.projection.bias": _np(proj["bias"]),
        "embeddings.position_embeddings": _np(params["pos_encoding"]),
    }
    for i in range(depth):
        blk, p = params[f"block{i}"], f"encoder.layer.{i}."
        attn, a = blk["self_attn"], p + "attention.attention."
        d_model = _np(attn["query"]["kernel"]).shape[0]

        def square(leaf):  # (D, H, hd) or (H, hd, D) → (D_out, D_in)
            return _np(leaf).reshape(d_model, d_model).T

        sd[a + "query.weight"] = square(attn["query"]["kernel"])
        sd[a + "q_bias"] = _np(attn["query"]["bias"]).reshape(-1)
        sd[a + "key.weight"] = square(attn["key"]["kernel"])
        k_bias = _np(attn["key"]["bias"]).reshape(-1)
        if np.any(k_bias):
            sd[a + "k_bias"] = k_bias
        sd[a + "value.weight"] = square(attn["value"]["kernel"])
        sd[a + "v_bias"] = _np(attn["value"]["bias"]).reshape(-1)
        sd[p + "attention.output.dense.weight"] = square(attn["out"]["kernel"])
        sd[p + "attention.output.dense.bias"] = _np(attn["out"]["bias"])
        sd[p + "layernorm_before.weight"] = _np(blk["norm1"]["scale"])
        sd[p + "layernorm_before.bias"] = _np(blk["norm1"]["bias"])
        sd[p + "layernorm_after.weight"] = _np(blk["norm2"]["scale"])
        sd[p + "layernorm_after.bias"] = _np(blk["norm2"]["bias"])
        sd[p + "intermediate.dense.weight"] = _np(blk["mlp_in"]["kernel"]).T
        sd[p + "intermediate.dense.bias"] = _np(blk["mlp_in"]["bias"])
        sd[p + "output.dense.weight"] = _np(blk["mlp_out"]["kernel"]).T
        sd[p + "output.dense.bias"] = _np(blk["mlp_out"]["bias"])
    if "final_norm" in params:
        sd["layernorm.weight"] = _np(params["final_norm"]["scale"])
        sd["layernorm.bias"] = _np(params["final_norm"]["bias"])
    return sd


def _export_conv(sd: Dict, key: str, leaf: Mapping) -> None:
    sd[key] = _np(leaf["kernel"]).transpose(3, 2, 0, 1)  # HWIO → (out, in, kh, kw)


def _export_bn(sd: Dict, prefix: str, affine: Mapping, stats: Mapping) -> None:
    sd[prefix + ".weight"] = _np(affine["scale"])
    sd[prefix + ".bias"] = _np(affine["bias"])
    sd[prefix + ".running_mean"] = _np(stats["mean"])
    sd[prefix + ".running_var"] = _np(stats["var"])


def export_resnet18_state_dict(params: Mapping, batch_stats: Mapping) -> Dict:
    """``ResNet18`` ``(params, batch_stats)`` → the torchvision ``resnet18`` layout
    (the feature extractor: no ``fc``)."""
    sd: Dict = {}
    _export_conv(sd, "conv1.weight", params["stem_conv"])
    _export_bn(sd, "bn1", params["stem_bn"], batch_stats["stem_bn"])
    for li in range(4):
        for bi in range(2):
            tp = f"layer{li + 1}.{bi}"
            p, s = params[f"layer{li}_{bi}"], batch_stats[f"layer{li}_{bi}"]
            _export_conv(sd, f"{tp}.conv1.weight", p["conv1"])
            _export_bn(sd, f"{tp}.bn1", p["bn1"], s["bn1"])
            _export_conv(sd, f"{tp}.conv2.weight", p["conv2"])
            _export_bn(sd, f"{tp}.bn2", p["bn2"], s["bn2"])
            if "downsample_conv" in p:
                _export_conv(sd, f"{tp}.downsample.0.weight", p["downsample_conv"])
                _export_bn(sd, f"{tp}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    return sd


def export_mobilenet_v2_state_dict(params: Mapping, batch_stats: Mapping) -> Dict:
    """``MobileNetV2`` ``(params, batch_stats)`` → the torchvision ``mobilenet_v2``
    layout (``.features`` only)."""
    sd: Dict = {}
    _export_conv(sd, "features.0.0.weight", params["stem_conv"])
    _export_bn(sd, "features.0.1", params["stem_bn"], batch_stats["stem_bn"])
    for i in range(17):
        p, s = params[f"ir{i}"], batch_stats[f"ir{i}"]
        for conv_key, bn_key, name in _mobilenet_layers(i):
            _export_conv(sd, conv_key + ".weight", p[f"{name}_conv"])
            _export_bn(sd, bn_key, p[f"{name}_bn"], s[f"{name}_bn"])
    _export_conv(sd, "features.18.0.weight", params["head_conv"])
    _export_bn(sd, "features.18.1", params["head_bn"], batch_stats["head_bn"])
    return sd


def export_video_backbone(variables: Mapping, config) -> Dict:
    """``convert_video_backbone``'s inverse on a ``VideoEncoder`` variable tree: the
    configured backbone out of ``variables["params"]`` (and ``["batch_stats"]``) as a
    flat torch-layout state dict."""
    backbone = config.model.video_backbone
    params = variables["params"]
    if _is_vit(backbone):
        depth, _, heads = _vit_shape(backbone)
        return export_videomae_state_dict(params["vit"], depth, heads)
    stats = dict(variables.get("batch_stats", {}) or {})
    if backbone == "resnet18":
        return export_resnet18_state_dict(params["backbone"], stats["backbone"])
    if backbone == "mobilenet_v2":
        return export_mobilenet_v2_state_dict(params["backbone"], stats["backbone"])
    raise ValueError(
        f"no torch-layout export for backbone {backbone!r} "
        "(tpu_cnn/tiny_cnn have no torch counterpart - checkpoint them natively)"
    )


# ---------------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------------
def save_state_dict(sd: Mapping, path) -> None:
    """Write a flat state dict as ``.npz`` (numpy) or ``.pt``/``.pth``/``.bin``
    (``torch.save``); ``load_state_dict`` reads either back."""
    path = str(path)
    if path.endswith(".npz"):
        np.savez(path, **{k: np.asarray(v) for k, v in sd.items()})
        return
    import torch

    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)


def normalize_state_dict(sd: Mapping) -> Dict:
    """Strip the ``module.`` (DataParallel) and ``model.`` (Lightning-style) prefixes
    that every key shares, to a fixpoint (``model.module.`` sheds both). A prefix only
    some keys carry (``videomae.`` beside a bare classification head) stays."""
    sd = dict(sd)
    stripped = True
    while stripped:
        stripped = False
        for prefix in ("module.", "model."):
            if sd and all(str(k).startswith(prefix) for k in sd):
                sd = {str(k)[len(prefix):]: v for k, v in sd.items()}
                stripped = True
    return sd


def load_state_dict(path) -> Dict:
    """A torch checkpoint (``.pt``/``.pth``/``.bin``) or a numpy ``.npz`` as a flat
    name → array dict, unwrapped from a ``state_dict`` envelope and shared key
    prefixes (``normalize_state_dict``)."""
    path = str(path)
    if path.endswith(".npz"):
        return normalize_state_dict(dict(np.load(path)))
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return normalize_state_dict(sd)


# ---------------------------------------------------------------------------------
# The graft
# ---------------------------------------------------------------------------------
def convert_video_backbone(sd: Mapping, config):
    """A raw state dict of the configured video backbone, converted: a params tree for
    a ViT (whose final LayerNorm must match ``model.video_use_final_norm``),
    ``(params, batch_stats)`` for ResNet-18 and MobileNetV2."""
    m, d = config.model, config.data
    backbone = m.video_backbone
    if _is_vit(backbone):
        depth, d_model, heads = _vit_shape(backbone)
        H, W = d.video_resize
        n_positions = (d.video_frames_per_window // 2) * (H // 16) * (W // 16)
        converted = convert_videomae_state_dict(sd, depth, d_model, heads, n_positions)
        has_norm = videomae_has_final_norm(sd)
        if has_norm != bool(getattr(m, "video_use_final_norm", True)):
            want = "without" if has_norm else "with"
            raise ValueError(
                f"checkpoint {'has' if has_norm else 'lacks'} a final LayerNorm but the "
                f"model is built {want} one - set model.video_use_final_norm={has_norm}"
            )
        return converted
    if backbone == "resnet18":
        return convert_resnet18_state_dict(sd)
    if backbone == "mobilenet_v2":
        return convert_mobilenet_v2_state_dict(sd)
    raise ValueError(
        f"no torch-weight converter for backbone {backbone!r} "
        "(tpu_cnn/tiny_cnn are this framework's own towers - train them natively)"
    )


def _shape_map(tree: Mapping, prefix: str = "") -> Dict[str, tuple]:
    """``"a/b/leaf"`` → shape for every leaf of a nested dict."""
    out: Dict[str, tuple] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_shape_map(value, path))
        else:
            out[path] = tuple(np.shape(value))
    return out


def graft_video_backbone(variables: Mapping, converted, backbone: str) -> Dict:
    """A ``VideoEncoder`` variable tree with its backbone replaced by ``converted``
    (new dicts; nothing of ``variables`` is changed)."""
    params = dict(variables["params"])
    if backbone.startswith("videomae"):
        params["vit"] = converted
        return {**variables, "params": params}
    bb_params, bb_stats = converted
    params["backbone"] = bb_params
    stats = dict(variables.get("batch_stats", {}) or {})
    stats["backbone"] = bb_stats
    return {**variables, "params": params, "batch_stats": stats}


def graft_model_video_weights(params: Mapping, batch_stats, config, *, path=None) -> tuple:
    """A model's ``(params, batch_stats)`` (any model with a ``video_encoder``:
    ``CrossModalModel``, ``VideoClassifier``, ``FusionClassifier``) with the checkpoint
    at ``path`` (default ``model.video_weights_path``) grafted into its
    ``video_encoder``. Every replaced leaf must keep its shape and no leaf may appear or
    vanish, so a checkpoint of another clip geometry raises instead of mis-grafting."""
    path = path or getattr(config.model, "video_weights_path", None)
    if not path:
        return params, batch_stats
    converted = convert_video_backbone(load_state_dict(path), config)
    ve = {
        "params": dict(params["video_encoder"]),
        "batch_stats": dict(dict(batch_stats or {}).get("video_encoder", {}) or {}),
    }
    old = _shape_map(ve)
    ve = graft_video_backbone(ve, converted, config.model.video_backbone)
    new = _shape_map(ve)
    mismatched = sorted(k for k in old.keys() & new.keys() if old[k] != new[k]) + sorted(new.keys() ^ old.keys())
    if mismatched:
        raise ValueError(
            f"video checkpoint {path} does not fit the configured model; first mismatches: {mismatched[:5]}"
        )
    out_params = dict(params)
    out_params["video_encoder"] = ve["params"]
    out_stats = dict(batch_stats or {})
    if ve.get("batch_stats"):
        out_stats["video_encoder"] = ve["batch_stats"]
    return out_params, out_stats
