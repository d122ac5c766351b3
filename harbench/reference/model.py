"""Plain PyTorch forwards of the benchmark's models, from the configuration file and a
flax-layout weight tree (``harbench.weights``), in float32 with TF32 off.

Nothing here imports the program: the featurizer, the encoders, the ImageNet
normalization (which the program folds into its stem), fusion, the head and the OOD
scores are written out again from their definitions. ``Precision("fp8")`` is the
control: every product's two operands rounded to float8 (e4m3, one scale a tensor)
before an f32 product.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS, BN_EPS = 1e-6, 1e-5
E4M3_MAX = 448.0


class Precision:
    """How the reference multiplies: ``"f32"`` (TF32 off) or ``"fp8"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the products read it; in fp8 rounded to e4m3 at a scale that maps
        its largest magnitude to 448, with the gradient passed straight through."""
        if self.kind == "f32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x).detach()

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)

    def dense(self, x, p: Mapping, d_in: Optional[int] = None):
        kernel = p["kernel"]
        kernel = kernel.reshape(d_in if d_in is not None else kernel.shape[0], -1)
        return self.matmul(x, kernel) + p["bias"].reshape(-1)

    def conv(self, x, kernel_hwio, stride: int, padding):
        return F.conv2d(self.q(x), self.q(kernel_hwio.permute(3, 2, 0, 1)), stride=stride, padding=padding)


class Dropout:
    """Dropout with the program's draws: a keep mask ``u >= rate`` with ``u`` uniform
    from ``generator`` on its device, in ``shape`` (else the input's), and the kept
    values scaled by ``1 / (1 - rate)``. The masks come from the same seeded generator,
    drawn in the order the model draws them."""

    def __init__(self, rate: float, generator: Optional[torch.Generator]):
        self.rate, self.generator = float(rate), generator

    def __call__(self, x, shape=None):
        if self.generator is None or self.rate <= 0.0:
            return x
        u = torch.rand(tuple(shape or x.shape), generator=self.generator, device=self.generator.device)
        return torch.where(u.to(x.device) >= self.rate, x / (1.0 - self.rate), torch.zeros((), device=x.device))


def layer_norm(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=LN_EPS)


def batch_norm_eval(x, p, stats):
    return (x - stats["mean"]) / torch.sqrt(stats["var"] + BN_EPS) * p["scale"] + p["bias"]


def batch_norm_train(x, p):
    mean, var = x.mean(dim=0), x.var(dim=0, unbiased=False)
    return (x - mean) / torch.sqrt(var + BN_EPS) * p["scale"] + p["bias"]


# --- IMU ---------------------------------------------------------------------------

def featurize(cfg: Mapping, raw: torch.Tensor) -> torch.Tensor:
    """Raw counts ``(B, T, 6)`` → ``(B, 6, T)``: acceleration over ``Racc`` (g), rate
    over ``Rgyro`` (deg/s), a median filter along time (zero-padded, odd taps), then a
    z-score over the window (population std + 1e-8)."""
    d = cfg["data"]
    units = torch.tensor([d["Racc"]] * 3 + [d["Rgyro"]] * 3, dtype=torch.float32, device=raw.device)
    x = raw.float() / units
    k = d["median_filter_kernel"]
    if k > 1:
        k += 1 - k % 2
        T = x.shape[1]
        xp = F.pad(x, (0, 0, k // 2, k // 2))
        x = torch.stack([xp[:, i:i + T] for i in range(k)]).median(dim=0).values
    if d["normalize_imu"]:
        x = (x - x.mean(dim=1, keepdim=True)) / (x.std(dim=1, correction=0, keepdim=True) + 1e-8)
    return x.transpose(1, 2)


def attention(pr: Precision, p, xq, xkv, heads: int, drop: Optional[Dropout] = None):
    """flax's multi-head attention: the query scaled by 1/sqrt(Dh) before the product,
    softmax over the keys, dropout on the weights (one mask over batch and heads)."""
    B, Nq, D = xq.shape
    Nk, dh = xkv.shape[1], D // heads

    def split(t, n):
        return t.view(B, n, heads, dh).transpose(1, 2)

    q = split(pr.dense(xq, p["query"], D), Nq) / math.sqrt(dh)
    k, v = split(pr.dense(xkv, p["key"], D), Nk), split(pr.dense(xkv, p["value"], D), Nk)
    w = torch.softmax(pr.matmul(q, k.transpose(-1, -2)), dim=-1)
    if drop is not None:
        w = drop(w, (1, 1, Nq, Nk))
    ctx = pr.matmul(w, v).transpose(1, 2).reshape(B, Nq, D)
    return pr.dense(ctx, p["out"], D)


def imu_encoder(cfg: Mapping, pr: Precision, p, x, drop: Optional[Dropout] = None):
    """Featurized windows ``(B, C, T)`` → tokens ``(B, 1 + C·N, D)``: a projection per
    channel of each patch, a CLS token, the positional table, post-norm ReLU blocks,
    a final LayerNorm."""
    m = cfg["model"]
    B, C, L = x.shape
    P, stride = m["imu_patch_size"], m["imu_stride"]
    n = (L - P) // stride + 1
    idx = (torch.arange(n, device=x.device) * stride)[:, None] + torch.arange(P, device=x.device)
    patches = x[:, :, idx]  # (B, C, n, P)
    kernel = p["patch_embed"]["kernel"]
    tok = torch.einsum("bcnp,cpd->bcnd", pr.q(patches), pr.q(kernel)) + p["patch_embed"]["bias"]
    D = kernel.shape[-1]
    tok = torch.cat([p["cls_token"].expand(B, 1, D), tok.reshape(B, C * n, D)], dim=1)
    tok = tok + p["pos_encoding"][:, : tok.shape[1]]
    keep = drop if drop is not None else (lambda t, shape=None: t)
    for i in range(m["imu_num_layers"]):
        b = p[f"block{i}"]
        a = keep(attention(pr, b["self_attn"], tok, tok, m["imu_nhead"], drop))
        tok = layer_norm(tok + a, b["norm1"])
        h = keep(torch.relu(pr.dense(tok, b["linear1"])))
        tok = layer_norm(tok + keep(pr.dense(h, b["linear2"])), b["norm2"])
    return layer_norm(tok, p["final_norm"])


# --- video -------------------------------------------------------------------------

def normalize_clip(u8: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=u8.device)
    std = torch.tensor(IMAGENET_STD, device=u8.device)
    return (u8.float() / 255.0 - mean) / std


def _same_pad(side: int, k: int, s: int):
    total = max((-(-side // s) - 1) * s + k - side, 0)
    return total // 2, total - total // 2


def tpu_cnn(cfg: Mapping, pr: Precision, p, stats, x):
    """Normalized NHWC frames ``(F, H, W, 3)`` → features ``(F, C)``: the VALID
    patch-size stem, eval BatchNorm and ReLU, residual 3×3 blocks, stride-2 SAME convs
    between stages, the spatial mean."""
    t = cfg["tower"]
    h = pr.conv(x.permute(0, 3, 1, 2), p["stem_conv"]["kernel"], t["patch"], 0)

    def bn(h, name):
        return batch_norm_eval(h.permute(0, 2, 3, 1), p[name], stats[name]).permute(0, 3, 1, 2)

    h = torch.relu(bn(h, "stem_bn"))
    for si in range(len(t["widths"])):
        if si > 0:
            lo, hi = _same_pad(h.shape[-1], 3, 2)
            h = pr.conv(F.pad(h, (lo, hi, lo, hi)), p[f"down{si}_conv"]["kernel"], 2, 0)
            h = torch.relu(bn(h, f"down{si}_bn"))
        for bi in range(t["blocks_per_stage"]):
            n = f"s{si}b{bi}"
            h2 = torch.relu(bn(pr.conv(h, p[f"{n}a_conv"]["kernel"], 1, 1), f"{n}a_bn"))
            h = torch.relu(bn(pr.conv(h2, p[f"{n}b_conv"]["kernel"], 1, 1), f"{n}b_bn") + h)
    return h.mean(dim=(2, 3))


def vit(cfg: Mapping, pr: Precision, p, x, gelu: str, checkpoint: bool = False):
    """Normalized clips ``(B, T, H, W, 3)`` → ``(mean token (B, D), tokens (B, N, D))``:
    tubelet patches in (t, h, w) order, each flattened in (kt, kh, kw, C) order, the
    positional table, pre-norm blocks, the final LayerNorm."""
    t = cfg["tower"]
    kt, kh, kw = t["tubelet"]
    B, T, H, W, C = x.shape
    x = x.reshape(B, T // kt, kt, H // kh, kh, W // kw, kw, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    tok = pr.dense(x.reshape(B, -1, kt * kh * kw * C), p["tubelet"]["proj"], kt * kh * kw * C) + p["pos_encoding"]

    def block(tok, b):
        h = layer_norm(tok, b["norm1"])
        tok = tok + attention(pr, b["self_attn"], h, h, t["heads"])
        h = F.gelu(pr.dense(layer_norm(tok, b["norm2"]), b["mlp_in"]), approximate=gelu)
        return tok + pr.dense(h, b["mlp_out"])

    for i in range(t["depth"]):
        if checkpoint:
            tok = torch.utils.checkpoint.checkpoint(block, tok, p[f"block{i}"], use_reentrant=False)
        else:
            tok = block(tok, p[f"block{i}"])
    if "final_norm" in p:
        tok = layer_norm(tok, p["final_norm"])
    return tok.mean(dim=1), tok


def video_tokens(cfg: Mapping, pr: Precision, tree, clip_u8, gelu: str):
    """uint8 NHWC clips → ``(embedding (B, Dv), tokens (B, N, Dv))`` after the
    encoder's projection."""
    p, stats = tree["params"]["video_encoder"], tree["batch_stats"].get("video_encoder", {})
    x = normalize_clip(clip_u8)
    if cfg["tower"]["kind"] == "cnn":
        B, T = x.shape[:2]
        feats = tpu_cnn(cfg, pr, p["backbone"], stats["backbone"], x.reshape(B * T, *x.shape[2:]))
        tok = pr.dense(feats.reshape(B, T, -1), p["projection"])
        return tok.mean(dim=1), tok
    emb, tok = vit(cfg, pr, p["vit"], x, gelu)
    return pr.dense(emb, p["projection"]), pr.dense(tok, p["projection"])


# --- fusion, head, scores ----------------------------------------------------------

def cross_block(cfg, pr: Precision, b, q, kv):
    q = q + attention(pr, b["cross_attn"], layer_norm(q, b["norm_q"]), layer_norm(kv, b["norm_kv"]),
                      cfg["model"]["fusion_heads"])
    h = F.gelu(pr.dense(layer_norm(q, b["norm_mlp"]), b["mlp_in"]), approximate="tanh")
    return q + pr.dense(h, b["mlp_out"])


def fusion_forward(cfg: Mapping, tree, raw_imu, clip_u8, *, gelu: str, precision: str = "f32") -> Dict:
    """The served function of a batch: raw counts and uint8 NHWC clips → logits, MSP
    and energy scores and the fused embedding, f32."""
    pr = Precision(precision)
    p, m = tree["params"], cfg["model"]
    hi = pr.dense(imu_encoder(cfg, pr, p["imu_encoder"], featurize(cfg, raw_imu)), p["imu_to_fusion"])
    hv = pr.dense(video_tokens(cfg, pr, tree, clip_u8, gelu)[1], p["video_to_fusion"])
    for i in range(m["fusion_layers"]):
        hi, hv = cross_block(cfg, pr, p[f"imu_xattn{i}"], hi, hv), cross_block(cfg, pr, p[f"video_xattn{i}"], hv, hi)
    fused = torch.cat([hi.mean(dim=1), hv.mean(dim=1)], dim=-1)
    x = fused
    for i in range(len(m["classifier_hidden_dims"])):
        x = torch.relu(layer_norm(pr.dense(x, p["classifier"][f"fc{i}"]), p["classifier"][f"ln{i}"]))
    logits = pr.dense(x, p["classifier"]["out"])
    t = float(cfg["ood"]["energy_temperature"])
    return {
        "logits": logits,
        "msp": 1.0 - torch.softmax(logits, dim=-1).max(dim=-1).values,
        "energy": -t * torch.logsumexp(logits / t, dim=-1),
        "embeddings": fused,
    }


@torch.no_grad()
def fusion_forward_blocks(cfg: Mapping, tree, raw_imu, clip_u8, *, gelu: str, block: int,
                          precision: str = "f32") -> Dict:
    """``fusion_forward`` over the rows in blocks of ``block``, TF32 off."""
    with full_f32():
        parts = [fusion_forward(cfg, tree, raw_imu[i:i + block], clip_u8[i:i + block], gelu=gelu,
                                precision=precision) for i in range(0, raw_imu.shape[0], block)]
    return {k: torch.cat([part[k] for part in parts]) for k in parts[0]}


class full_f32:
    """f32 products in f32 inside the block: TF32 off for cuBLAS and cuDNN."""

    def __enter__(self):
        self.before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.before
