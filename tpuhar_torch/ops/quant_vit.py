"""int8 PTQ of the VideoMAE ViT video tower (``tpuhar/ops/quant_vit.py``).

The three phases of the CNN towers' PTQ (``ops/quant.py``):

- ``calibrate_vit``: an f32 mirror of the ViT at eval (``vit_forward_f32``) that
  records the absmax of every dense layer's input: ``tubelet`` and each block's
  ``qkv_in``, ``attn_out_in``, ``mlp_in`` and ``mlp_mid``;
- ``quantize_vit``: int8 weights per output channel, the query, key and value
  projections merged into one ``(d, 3·H·Dh)`` product, f32 biases, LayerNorm parameters
  and positions; ``input_fold=(mean, std)`` folds the ImageNet normalization into the
  tubelet stem, which then reads raw uint8 pixels as ``clip(u8 − 128, −127, 127)``;
- ``quant_vit_forward``: int8 dense layers, attention in ``attn_dtype`` with its softmax
  in f32 and the scores materialized, LayerNorm statistics in f32, the residual stream in
  ``stream_dtype`` (both bf16 by default, as the JAX package serves it).

On a CUDA device every dense layer (4 a block) runs through ``ops/stem.int8_gemm`` and
the folded tubelet stem through ``ops/stem.stem_gemm_u8`` on the clip's patches; the
attention products are plain ``torch.matmul``, as the JAX package computes them outside
any Pallas kernel. The arithmetic follows the JAX package op for op (``_ln`` takes
``jnp.var``'s mean of squared deviations; ``1/sqrt(Dh)`` is rounded to ``attn_dtype``
and multiplies q before the product; GELU is the exact erf form).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .quant import _leaves, _observed, _tensor, quantize_activations, quantize_weights, with_site
from .stem import int8_gemm, stem_gemm_u8

_LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _vit_layout(params) -> Tuple[int, int, int]:
    """``(depth, num_heads, head_dim)`` of a VideoViT parameter tree."""
    depth = 0
    while f"block{depth}" in params:
        depth += 1
    qk = params["block0"]["self_attn"]["query"]["kernel"]
    return depth, int(qk.shape[1]), int(qk.shape[2])


def _patchify(x: torch.Tensor, kt: int, kh: int, kw: int) -> torch.Tensor:
    """``(B, T, H, W, C)`` → ``(B, N, kt·kh·kw·C)`` tubelet patches: each patch in the
    ``(kt, kh, kw, C)`` order of the flax conv kernel reshaped to ``(kt·kh·kw·C, d)``,
    the tokens in the conv output's ``(t, h, w)`` order. A view where it can be."""
    B, T, H, W, C = x.shape
    x = x.reshape(B, T // kt, kt, H // kh, kh, W // kw, kw, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, (T // kt) * (H // kh) * (W // kw), kt * kh * kw * C)


def _ln(x: torch.Tensor, p) -> torch.Tensor:
    """LayerNorm with f32 statistics whatever the stream's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + _LN_EPS)
    return y * _tensor(p["scale"], xf.device) + _tensor(p["bias"], xf.device)


def _dense_f32(x, p) -> torch.Tensor:
    return x @ _tensor(p["kernel"], x.device) + _tensor(p["bias"], x.device)


def _attention_f32(h: torch.Tensor, ap, heads: int) -> torch.Tensor:
    """f32 mirror of flax's ``MultiHeadDotProductAttention`` (self-attention): the
    context ``(B, N, heads·head_dim)`` before the out projection, whose input is a
    calibration site."""
    B, N, D = h.shape

    def proj(name):
        k = _tensor(ap[name]["kernel"], h.device)  # (D, H, Dh)
        return (h @ k.reshape(D, -1)).reshape(B, N, heads, -1) + _tensor(ap[name]["bias"], h.device)

    q, k, v = proj("query"), proj("key"), proj("value")
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q / torch.sqrt(torch.tensor(float(dh))), k)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, heads * dh)


@torch.inference_mode()
def vit_forward_f32(params, clip: torch.Tensor, *, stats: Dict = None) -> torch.Tensor:
    """f32 mirror of the ViT at eval → tokens after the final norm ``(B, N, d)``.

    With ``stats``, records the absmax of each dense layer's input (the calibration
    sites)."""
    depth, heads, dh = _vit_layout(params)
    tk = _tensor(params["tubelet"]["proj"]["kernel"], clip.device)
    kt, kh, kw = (int(v) for v in tk.shape[:3])
    d_model = int(tk.shape[-1])

    def see(name, x):
        if stats is not None:
            _observed(stats, name, x)

    x = clip.float()
    see("tubelet", x)
    x = _patchify(x, kt, kh, kw) @ tk.reshape(-1, d_model) + _tensor(params["tubelet"]["proj"]["bias"], x.device)
    x = x + _tensor(params["pos_encoding"], x.device)[:, : x.shape[1]]
    for i in range(depth):
        bp = params[f"block{i}"]
        h = _ln(x, bp["norm1"])
        see(f"block{i}.qkv_in", h)
        ctx = _attention_f32(h, bp["self_attn"], heads)
        see(f"block{i}.attn_out_in", ctx)
        op = bp["self_attn"]["out"]
        x = x + (ctx @ _tensor(op["kernel"], x.device).reshape(heads * dh, d_model) + _tensor(op["bias"], x.device))
        h = _ln(x, bp["norm2"])
        see(f"block{i}.mlp_in", h)
        mid = F.gelu(_dense_f32(h, bp["mlp_in"]))
        see(f"block{i}.mlp_mid", mid)
        x = x + _dense_f32(mid, bp["mlp_out"])
    if "final_norm" in params:
        x = _ln(x, params["final_norm"])
    return x


def calibrate_vit(params, batch_stats, clips: torch.Tensor) -> Dict[str, float]:
    """Per-site absmax over calibration clips (normalized f32 ``(N, T, H, W, 3)``).
    ``batch_stats`` is taken for the CNN calibrators' signature and ignored: the ViT
    has none."""
    del batch_stats
    stats: Dict[str, float] = {}
    vit_forward_f32(params, clips, stats=stats)
    return stats


@torch.inference_mode()
def quantize_vit(params, batch_stats, act_stats: Dict[str, float], *, input_fold=None, device="cpu") -> Dict:
    """The int8 ViT's tree: merged-QKV, out and MLP int8 weights, f32 biases, LayerNorm
    parameters and positions. Returns the forward's tree (``vit_tree_from_numpy``) on
    ``device``.

    ``input_fold=(mean, std)`` folds the ImageNet normalization into the tubelet stem as
    ``quantize_tpucnn`` folds it into its stem: ``a = 1/(255·std)`` scales each kernel
    row by its channel, ``c = (128/255 − mean)/std`` summed over the taps goes into the
    bias (exact: the stem is a VALID conv whose stride is its kernel)."""
    del batch_stats
    depth, heads, dh = _vit_layout(params)
    tk = _tensor(params["tubelet"]["proj"]["kernel"], device)
    d_model = int(tk.shape[-1])

    def site_scale(name):
        return np.float32(max(act_stats.get(name, 1.0), 1e-6) / 127.0)

    def pack_dense(kernel, bias):
        w_q, w_s = quantize_weights(kernel, axis=-1)
        return {"w_q": w_q, "w_scale": w_s.reshape(-1), "bias": bias}

    kernel = tk.reshape(-1, d_model)
    bias = _tensor(params["tubelet"]["proj"]["bias"], device)
    if input_fold is not None:
        mean, std = (torch.tensor(v, dtype=torch.float32, device=device) for v in input_fold)
        a = 1.0 / (255.0 * std)
        c = (128.0 / 255.0 - mean) / std
        taps = tk.reshape(-1, 3, d_model)  # rows in (kt, kh, kw, C) order
        bias = bias + torch.einsum("c,kcd->d", c, taps)
        kernel = (taps * a[:, None]).reshape(-1, d_model)
    q: Dict = {
        "act_scales": {k: site_scale(k) for k in act_stats},
        "depth": depth,
        "heads": heads,
        "head_dim": dh,
        "tubelet": tuple(int(v) for v in tk.shape[:3]),
        "input_fold": input_fold is not None,
        "pos": _tensor(params["pos_encoding"], device),
        "stem": pack_dense(kernel, bias),
    }
    if "final_norm" in params:
        q["final_norm"] = dict(params["final_norm"])

    def kernel_of(p, *shape):
        return _tensor(p["kernel"], device).reshape(*shape)

    for i in range(depth):
        bp = params[f"block{i}"]
        ap = bp["self_attn"]
        names = ("query", "key", "value")
        q[f"block{i}"] = {
            "norm1": dict(bp["norm1"]),
            "norm2": dict(bp["norm2"]),
            "qkv": pack_dense(
                torch.cat([kernel_of(ap[n], d_model, heads * dh) for n in names], dim=1),
                torch.cat([_tensor(ap[n]["bias"], device).reshape(heads * dh) for n in names]),
            ),
            "out": pack_dense(kernel_of(ap["out"], heads * dh, d_model), _tensor(ap["out"]["bias"], device)),
            "mlp_in": pack_dense(kernel_of(bp["mlp_in"], d_model, -1), _tensor(bp["mlp_in"]["bias"], device)),
            "mlp_out": pack_dense(kernel_of(bp["mlp_out"], -1, d_model), _tensor(bp["mlp_out"]["bias"], device)),
        }
    return vit_tree_from_numpy(q, device)


_DENSE_SITES = {"qkv": "qkv_in", "out": "attn_out_in", "mlp_in": "mlp_in", "mlp_out": "mlp_mid"}


def vit_tree_from_numpy(q: Dict, device="cpu") -> Dict:
    """The JAX package's quantized ViT tree (numpy or torch leaves) → the forward's tree
    on ``device``.

    Each dense layer keeps ``w_q`` ``(in, out)``, ``w_scale`` and ``bias`` and gains
    ``w_packed``, the K-major ``(out, in)`` matrix ``int8_gemm`` reads, and its input
    site's ``x_scale`` and ``xs_ws`` (``ops/quant.with_site``). The folded stem's codes
    carry no scale: its ``x_scale`` is 1 (``xs_ws`` is ``w_scale``, as the JAX package
    multiplies by ``1.0 · w_scale``). Positions and LayerNorm parameters become f32
    tensors; site scales Python floats that hold the exact f32 values."""
    scales = {k: float(np.float32(v)) for k, v in q["act_scales"].items()}
    fold = bool(q["input_fold"])

    def dense(entry, x_scale):
        layer = with_site(_leaves(entry, device), x_scale, device)
        layer["w_packed"] = layer["w_q"].T.contiguous()
        return layer

    def norm(p):
        return {k: _tensor(p[k], device).contiguous() for k in ("scale", "bias")}

    out: Dict = {
        "act_scales": scales,
        "depth": int(q["depth"]),
        "heads": int(q["heads"]),
        "head_dim": int(q["head_dim"]),
        "tubelet": tuple(int(v) for v in q["tubelet"]),
        "input_fold": fold,
        "pos": _tensor(q["pos"], device).contiguous(),
        "stem": dense(q["stem"], 1.0 if fold else scales["tubelet"]),
    }
    if "final_norm" in q:
        out["final_norm"] = norm(q["final_norm"])
    for i in range(out["depth"]):
        bq = q[f"block{i}"]
        block = {"norm1": norm(bq["norm1"]), "norm2": norm(bq["norm2"])}
        for name, site in _DENSE_SITES.items():
            block[name] = dense(bq[name], scales[f"block{i}.{site}"])
        out[f"block{i}"] = block
    return out


def _qdense(x: torch.Tensor, layer: Dict) -> torch.Tensor:
    """``int8_dense(quantize(x), w_q) + bias``: the codes at the layer's site, the product
    and its rescale through ``int8_gemm``; f32 ``(..., out)``."""
    x_q = quantize_activations(x.contiguous(), layer["x_scale"])
    return int8_gemm(x_q, layer["w_packed"], layer["xs_ws"], layer["bias"])


@torch.inference_mode()
def quant_vit_forward(
    q: Dict, clip: torch.Tensor, *, attn_dtype=torch.bfloat16, stream_dtype=torch.bfloat16
) -> torch.Tensor:
    """int8 ViT tokens after the final norm, ``(B, N, d)`` f32.

    ``clip`` is ``(B, T, H, W, 3)``: raw uint8 when the tree was built with
    ``input_fold``, else normalized f32. Attention runs in ``attn_dtype`` (its scores
    materialized, their softmax in f32), the residual stream in ``stream_dtype``."""
    heads, dh = q["heads"], q["head_dim"]
    kt, kh, kw = q["tubelet"]
    stem = q["stem"]
    if q["input_fold"]:
        if clip.dtype != torch.uint8:
            raise TypeError(f"a tree built with input_fold takes the raw uint8 clip, got {clip.dtype}")
        tokens = _patchify(clip, kt, kh, kw).contiguous()
        x = stem_gemm_u8(tokens, stem["w_packed"], stem["xs_ws"], stem["bias"], relu=False)
    else:
        x = _qdense(_patchify(clip.float(), kt, kh, kw), stem)
    B, N = x.shape[:2]
    x = (x + q["pos"][:, :N]).to(stream_dtype)
    # 1/sqrt(Dh) rounded to attn_dtype, as a Python float: a product with it rounds once
    inv_sqrt_dh = float(torch.tensor(1.0 / np.sqrt(dh), dtype=attn_dtype))
    for i in range(q["depth"]):
        bq = q[f"block{i}"]
        qkv = _qdense(_ln(x, bq["norm1"]), bq["qkv"])
        qkv = qkv.reshape(B, N, 3, heads, dh).to(attn_dtype).permute(2, 0, 3, 1, 4)  # (3, B, H, N, Dh)
        scores = torch.matmul(qkv[0] * inv_sqrt_dh, qkv[1].transpose(-1, -2))
        attn = torch.softmax(scores, dim=-1, dtype=torch.float32).to(attn_dtype)
        del scores
        ctx = torch.matmul(attn, qkv[2]).transpose(1, 2).reshape(B, N, heads * dh)
        del attn
        x = x + _qdense(ctx.float(), bq["out"]).to(stream_dtype)
        mid = F.gelu(_qdense(_ln(x, bq["norm2"]), bq["mlp_in"]))
        x = x + _qdense(mid, bq["mlp_out"]).to(stream_dtype)
    if "final_norm" in q:
        return _ln(x, q["final_norm"])
    return x.float()
