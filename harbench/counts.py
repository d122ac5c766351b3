"""The yardstick's arithmetic: the card's published peaks and the operations and bytes
of the work the cells measure, counted from the configuration's shapes.

The peaks are NVIDIA's data sheet for one H100 SXM, dense, at the full 700 W power
limit; they are frozen here so that the yardstick does not move when the program does.
Every count is of the *function* (its shapes), not of what a kernel happens to do:
multiply-adds count two operations, and each input byte is read once and each output
byte written once.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, bytes_moved: float, kind: str = "bf16") -> float:
    """The least time the card could take: operations over the peak of ``kind`` or bytes
    over the memory rate, whichever is larger."""
    return max(ops / PEAK_OPS_PER_S[kind], bytes_moved / HBM_BYTES_PER_S)


# --- kernels -----------------------------------------------------------------------

def conv3x3_ops(frames: int, side: int, c_in: int, c_out: int) -> float:
    """A 3×3 SAME conv at stride 1 over ``frames`` square planes of ``side``²."""
    return 2.0 * frames * side * side * 9 * c_in * c_out


def conv3x3_bytes(frames: int, side: int, c_in: int, c_out: int, *, residual: bool, elem: int = 2) -> float:
    """Input, weights, the residual where there is one, and the output, each once; the
    folded BatchNorm's f32 scale and shift."""
    plane = frames * side * side
    moved = plane * c_in + 9 * c_in * c_out + plane * c_out * (2 if residual else 1)
    return moved * elem + 2 * c_out * 4


def attention_fwd_ops(batch: int, heads: int, tokens: int, head_dim: int) -> float:
    """Softmax attention's two products, S = QKᵀ and O = PV: 4·B·H·N²·d."""
    return 4.0 * batch * heads * tokens * tokens * head_dim


def attention_bwd_ops(batch: int, heads: int, tokens: int, head_dim: int) -> float:
    """The backward's five products (S recomputed, dV, dP, dQ, dK): 10·B·H·N²·d."""
    return 10.0 * batch * heads * tokens * tokens * head_dim


def tpu_cnn_convs(cfg: Mapping, frames: int):
    """``(side, c_in, c_out, residual)`` of each fused residual 3×3 conv of the
    ``tpu_cnn`` tower, and the frames each sees."""
    tower, data = cfg["tower"], cfg["data"]
    side = data["video_resize"][0] // tower["patch"]
    convs = []
    for si, c in enumerate(tower["widths"]):
        if si > 0:
            side = (side + 1) // 2
        for _ in range(tower["blocks_per_stage"]):
            convs += [(side, c, c, False), (side, c, c, True)]
    return convs


def conv3x3_forward(cfg: Mapping, batch: int) -> Dict[str, float]:
    """The fused convs of one forward of ``batch`` windows: launches, operations and
    the least time."""
    frames = batch * cfg["data"]["video_frames_per_window"]
    convs = tpu_cnn_convs(cfg, frames)
    return {
        "launches": len(convs),
        "ops": sum(conv3x3_ops(frames, s, ci, co) for s, ci, co, _ in convs),
        "bound_s": sum(bound_s(conv3x3_ops(frames, s, ci, co), conv3x3_bytes(frames, s, ci, co, residual=r))
                       for s, ci, co, r in convs),
    }


def vit_attention(cfg: Mapping, batch: int) -> Dict[str, float]:
    """The ViT's attention of ``batch`` clips: one launch a block, its forward and
    backward operations and least times (bound by operations at these shapes)."""
    t = cfg["tower"]
    heads, dh, n = t["heads"], t["d_model"] // t["heads"], vit_tokens(cfg)
    fwd, bwd = attention_fwd_ops(batch, heads, n, dh), attention_bwd_ops(batch, heads, n, dh)
    return {"launches": t["depth"], "fwd_ops": fwd, "bwd_ops": bwd,
            "fwd_bound_s": bound_s(fwd, 0.0), "bwd_bound_s": bound_s(bwd, 0.0)}


# --- whole models ------------------------------------------------------------------

def dense(tokens: float, d_in: int, d_out: int) -> float:
    return 2.0 * tokens * d_in * d_out


def mha(nq: float, nk: float, d: int) -> float:
    """q/k/v/out projections and the two attention products (d split over heads)."""
    return dense(nq, d, d) * 2 + dense(nk, d, d) * 2 + 4.0 * nq * nk * d


def imu_tokens(cfg: Mapping) -> int:
    m, data = cfg["model"], cfg["data"]
    n = (data["imu_window_size"] - m["imu_patch_size"]) // m["imu_stride"] + 1
    return 1 + data["imu_channels"] * n


def vit_tokens(cfg: Mapping) -> int:
    kt, kh, kw = cfg["tower"]["tubelet"]
    H, W = cfg["data"]["video_resize"]
    return (cfg["data"]["video_frames_per_window"] // kt) * (H // kh) * (W // kw)


def imu_encoder_flops(cfg: Mapping) -> float:
    m, data = cfg["model"], cfg["data"]
    d, n = m["imu_d_model"], imu_tokens(cfg)
    patches = dense((n - 1), m["imu_patch_size"], d)
    block = mha(n, n, d) + dense(n, d, 4 * d) + dense(n, 4 * d, d)
    return patches + m["imu_num_layers"] * block


def video_tower_flops(cfg: Mapping) -> Dict[str, float]:
    """The tower's operations for one clip, and the width and count of its tokens."""
    t, data = cfg["tower"], cfg["data"]
    T = data["video_frames_per_window"]
    H, W = data["video_resize"]
    if t["kind"] == "cnn":
        p = t["patch"]
        side = H // p
        ops = dense(T * side * side, p * p * 3, t["widths"][0])  # the patch-embed stem
        prev = t["widths"][0]
        for si, c in enumerate(t["widths"]):
            if si > 0:
                side = (side + 1) // 2
                ops += T * side * side * 2.0 * 9 * prev * c  # the stride-2 conv
            ops += 2 * t["blocks_per_stage"] * conv3x3_ops(T, side, c, c)
            prev = c
        return {"ops": ops, "feature_dim": t["feature_dim"], "tokens": T}
    n, d = vit_tokens(cfg), t["d_model"]
    kt, kh, kw = t["tubelet"]
    block = mha(n, n, d) + dense(n, d, t["mlp"]) + dense(n, t["mlp"], d)
    return {"ops": dense(n, kt * kh * kw * 3, d) + t["depth"] * block, "feature_dim": d, "tokens": n}


def fusion_flops(cfg: Mapping) -> float:
    """The serving forward of one window: IMU encoder, video tower and its projection,
    the fusion rounds and the classifier head (elementwise work not counted)."""
    m = cfg["model"]
    tower = video_tower_flops(cfg)
    d, dv, ni, nv = m["imu_d_model"], m["video_d_model"], imu_tokens(cfg), tower["tokens"]
    ops = imu_encoder_flops(cfg) + tower["ops"]
    if cfg["tower"]["kind"] == "cnn":
        ops += dense(nv, tower["feature_dim"], dv)  # the projection, per frame
    else:
        ops += dense(nv + 1, tower["feature_dim"], dv)  # on the tokens and on their mean
    ops += dense(ni, d, d) + dense(nv, dv, d)
    def mlp(n):
        return dense(n, d, 4 * d) + dense(n, 4 * d, d)

    ops += m["fusion_layers"] * (mha(ni, nv, d) + mha(nv, ni, d) + mlp(ni) + mlp(nv))
    dims = [2 * d, *m["classifier_hidden_dims"], m["num_classes"]]
    ops += sum(dense(1, a, b) for a, b in zip(dims, dims[1:]))
    return ops


def pretrain_forward_flops(cfg: Mapping) -> float:
    """The pretraining model's forward for one sample: both encoders, the video
    projection (on the tokens and their mean), and both projection heads."""
    m = cfg["model"]
    tower = video_tower_flops(cfg)
    dv, hid, out = m["video_d_model"], m["projection_hidden_dim"], m["projection_dim"]
    ops = imu_encoder_flops(cfg) + tower["ops"] + dense(tower["tokens"] + 1, tower["feature_dim"], dv)
    ops += dense(1, m["imu_d_model"], hid) + dense(1, hid, out) + dense(1, dv, hid) + dense(1, hid, out)
    return ops


def train_step_flops(cfg: Mapping, batch: int) -> float:
    """Three forwards' worth a sample: the forward and a backward of twice its work."""
    return 3.0 * pretrain_forward_flops(cfg) * batch


def mfu_pct(flops: float, seconds: float, kind: str = "bf16") -> float:
    """The share of the peak of ``kind`` that ``flops`` in ``seconds`` make, in %."""
    if not (seconds > 0 and math.isfinite(seconds)):
        raise ValueError(f"no time to divide by: {seconds}")
    return 100.0 * flops / seconds / PEAK_OPS_PER_S[kind]
