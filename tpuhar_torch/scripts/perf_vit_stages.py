"""The ViT serving step unit by unit, against the card's floors
(``scripts/perf_vit_stages.py``).

At ``videomae_small``'s published width (d 384, 6 heads, 12 blocks) on 16 frames of
224² (N = 8·14·14 = 1568 tokens) at the batch given (default 64), in bf16, it times
each unit of one transformer block and the whole model:

- ``null``: one elementwise pass over the tokens (what every unit's own time includes
  of dependence and launch; subtracted from each unit);
- ``layernorm`` (f32 statistics, no affine); ``qkv_3gemm`` (three (d, d) GEMMs) and
  ``qkv_merged`` (one (d, 3d) GEMM); ``scores_qk``; ``attn_core_bf16`` (bf16 scores,
  an f32 softmax, AV) and ``attn_core_f32scores`` (the scores in f32); ``out_proj``;
  ``mlp_in_gelu`` (the (d, 4d) GEMM and the exact GELU); ``mlp_out``;
  ``tubelet_gemm`` (the tubelet stem as a patchify copy and one GEMM);
- ``full_model``: the port's ``VideoViT`` forward (the reference's default: attention
  without flash, the exact GELU), weights of seed 0.

Each unit is set against its floor, the larger of its operations over the card's bf16
peak and its bytes over its memory rate (``utils/roofline.bound``; the operation and
byte counts are the JAX script's). Each time is ``profile_step.median_ms``.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.perf_vit_stages [batch=64] [--cpu]``
"""
from __future__ import annotations

import argparse
import json
import math

import torch
import torch.nn.functional as F

from ._common import card_line, log, script_device, shown

ITERS, TRIALS = 12, 3
BLOCK = ("layernorm", "qkv_3gemm", "attn_core_bf16", "out_proj", "layernorm", "mlp_in_gelu", "mlp_out")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=64)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def scores_f32(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q kᵀ`` of bf16 operands with f32 products and output: the card's GEMM with
    ``out_dtype``; on the CPU the same values through an f32 GEMM."""
    B, H, N, D = q.shape
    if q.is_cuda:
        return torch.bmm(q.reshape(B * H, N, D), k.reshape(B * H, N, D).transpose(1, 2),
                         out_dtype=torch.float32).reshape(B, H, N, N)
    return q.float() @ k.float().transpose(-1, -2)


def run(batch: int = 64, *, cpu: bool = False, backbone: str = "videomae_small", frames: int = 16, size: int = 224,
        iters: int = ITERS, trials: int = TRIALS) -> dict:
    """``{"bench": "vit_stage_decompose", "batch", "null_ms", "units_ms", "floors_ms",
    "model_est_ms", "model_floor_ms", "full_model_ms"}`` (the JAX script's keys) plus
    ``"device"``."""
    from ..bridge import init_params, load_variables
    from ..config import Config
    from ..models.crossmodal import VideoClassifier
    from ..models.video import TUBELET, VIT_CONFIGS
    from ..profile_step import median_ms
    from ..utils.roofline import bound

    device = script_device(cpu)
    card = card_line(device)
    depth, d, heads = VIT_CONFIGS[backbone]
    kt, kh, kw = TUBELET
    N = (frames // kt) * (size // kh) * (size // kw)
    hd = d // heads
    bf = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=device) * std).to(bf)

    def floor(flops, nbytes):
        return bound(nbytes, {"bf16": flops})["bound_ms"]

    def timed(fn, x, n=iters):
        return median_ms(fn, (x,), trials=trials, iters=n, device=device)

    tokens, flat = normal(batch, N, d), normal(batch * N, d)
    wq, wk, wv, wo = (normal(d, d, std=0.02) for _ in range(4))
    wqkv = normal(d, 3 * d, std=0.02)
    w1, w2 = normal(d, 4 * d, std=0.02), normal(4 * d, d, std=0.02)
    q3 = normal(batch, heads, N, hd)
    hid = normal(batch * N, 4 * d)
    patch = kt * kh * kw * 3
    wt = normal(patch, d, std=0.02)
    clip = normal(batch, frames, size, size, 3)
    toks_bytes = batch * N * d * 2
    sc_bytes = batch * heads * N * N * 2
    clip_bytes = batch * frames * size * size * 3 * 2

    def layernorm(x):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        return ((x32 - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)

    def attn_core(q, f32_scores=False):
        s = scores_f32(q, q) / math.sqrt(hd) if f32_scores else (q @ q.transpose(-1, -2) / math.sqrt(hd)).float()
        return torch.softmax(s, dim=-1).to(q.dtype) @ q

    def tubelet(x):
        v = x.reshape(batch, frames // kt, kt, size // kh, kh, size // kw, kw, 3)
        v = v.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(batch * N, patch)
        return v @ wt

    units, floors = {}, {}
    with torch.inference_mode():
        log("timing the null unit ...")
        t_null = timed(lambda x: x * 1.0001, tokens)
        plan = [
            ("layernorm", layernorm, tokens, floor(0, 2 * toks_bytes)),
            ("qkv_3gemm", lambda x: (x @ wq) + (x @ wk) + (x @ wv), flat,
             floor(3 * 2 * batch * N * d * d, 4 * toks_bytes)),
            ("qkv_merged", lambda x: x @ wqkv, flat, floor(3 * 2 * batch * N * d * d, 4 * toks_bytes)),
            ("scores_qk", lambda q: q @ q.transpose(-1, -2), q3,
             floor(2 * batch * heads * N * N * hd, 2 * toks_bytes + sc_bytes)),
            ("attn_core_bf16", attn_core, q3, floor(2 * 2 * batch * heads * N * N * hd, 2 * toks_bytes + 3 * sc_bytes)),
            ("attn_core_f32scores", lambda q: attn_core(q, True), q3, None),
            ("out_proj", lambda x: x @ wo, flat, floor(2 * batch * N * d * d, 2 * toks_bytes)),
            ("mlp_in_gelu", lambda x: F.gelu((x @ w1).float()).to(x.dtype), flat,
             floor(2 * batch * N * d * 4 * d, 5 * toks_bytes)),
            ("mlp_out", lambda x: x @ w2, hid, floor(2 * batch * N * d * 4 * d, 5 * toks_bytes)),
            ("tubelet_gemm", tubelet, clip, floor(2 * batch * N * patch * d, 2 * clip_bytes + toks_bytes)),
        ]
        for name, fn, x, fl in plan:
            log(f"timing {name} ...")
            units[name] = timed(fn, x)
            if fl is not None:
                floors[name] = fl

        log(f"timing the whole {backbone} forward ...")
        cfg = Config()
        cfg.model.video_backbone, cfg.model.video_pretrained = backbone, False
        cfg.model.compute_dtype = "bfloat16"
        cfg.data.video_frames_per_window, cfg.data.video_resize = frames, (size, size)
        model = load_variables(VideoClassifier(cfg, dtype=bf),
                               init_params(cfg, torch.Generator().manual_seed(0), VideoClassifier)).to(device).eval()
        vit = model.video_encoder.vit
        units["full_model"] = timed(lambda x: vit(x)[0], clip, max(4, iters // 2))

    def own(u):  # a unit's time less the null unit's; None where no trial ran
        t = units[u]
        return None if t is None or t_null is None else t - (t_null if u != "full_model" else 0.0)

    def ratio(a, b):
        return None if a is None or b is None or b <= 0 else a / b

    blk = [own(u) for u in BLOCK] + [own("tubelet_gemm")]
    model_est = None if None in blk else depth * sum(blk[:-1]) + blk[-1]
    model_floor = depth * sum(floors[u] for u in BLOCK) + floors["tubelet_gemm"]
    log("\n| unit | measured ms | floor ms | floor / measured |")
    log("|---|---|---|---|")
    for u in units:
        fl = floors.get(u)
        log(f"| {u} | {shown(own(u), '.4f')} | {shown(fl, '.4f')} | {shown(ratio(fl, own(u)), '.2f')} |")
    log(f"| {depth} blocks + stem (sum of units) | {shown(model_est)} | {model_floor:.3f} | "
        f"{shown(ratio(model_floor, model_est), '.2f')} |")
    log(f"| full model measured | {shown(units['full_model'])} | {model_floor:.3f} | "
        f"{shown(ratio(model_floor, units['full_model']), '.2f')} |")
    gains = [None if None in (units[a], units[b]) else (units[a] - units[b]) * depth
             for a, b in (("qkv_3gemm", "qkv_merged"), ("attn_core_f32scores", "attn_core_bf16"))]
    log(f"merged QKV saves {shown(gains[0])} ms a model; f32 scores cost {shown(gains[1])} ms a model ({card})")
    result = {"bench": "vit_stage_decompose", "batch": batch, "device": card, "null_ms": t_null, "units_ms": units,
              "floors_ms": floors, "model_est_ms": model_est, "model_floor_ms": model_floor,
              "full_model_ms": units["full_model"]}
    print(json.dumps(result))
    return result


def main(argv=None):
    args = parse_args(argv)
    return run(args.batch, cpu=args.cpu)


if __name__ == "__main__":
    main()
