"""Shared building blocks with flax semantics (``tpuhar/models/layers.py``).

Each module's attribute names are its flax submodule names, so ``bridge`` maps a
flax variable tree onto it by name. Modules take the compute ``dtype`` at
construction, as flax modules do; LayerNorm eps is flax's 1e-6, BatchNorm's 1e-5.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import FlashSelfAttention, head_projections

LN_EPS = 1e-6  # flax nn.LayerNorm default (torch's is 1e-5)
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis with flax's variable names: params
    ``scale``/``bias``, running stats ``mean``/``var``. Kept and applied in f32."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(features), requires_grad=False)
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))

    def forward(self, x):
        s = self.scale * torch.rsqrt(self.var + BN_EPS)
        return ((x.float() - self.mean) * s + self.bias).to(x.dtype)


def norm_layer(kind: str, features: int, *, dtype=torch.float32) -> nn.Module:
    """Head norm selector: "layer" (LayerNorm) or "batch" (eval BatchNorm)."""
    if kind == "layer":
        return nn.LayerNorm(features, eps=LN_EPS, dtype=dtype)
    if kind == "batch":
        return BatchNorm(features)
    raise ValueError(f"Unknown norm kind: {kind}")


class MultiHeadDotProductAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` at eval: q/k/v ``DenseGeneral``
    to ``(H, Dh)`` with per-head bias, the query scaled by ``1/sqrt(Dh)`` before the
    dot, a softmax over keys (in f32), and an ``out`` ``DenseGeneral`` back to D."""

    def __init__(self, d_model: int, num_heads: int, *, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value, self.out = head_projections(d_model, num_heads, dtype=dtype)

    def forward(self, inputs_q, inputs_kv):
        B, Nq, D = inputs_q.shape
        H = self.num_heads
        Dh = D // H

        def heads(t):  # (B, N, H·Dh) → (B, H, N, Dh)
            return t.view(B, t.shape[1], H, Dh).transpose(1, 2)

        q = heads(self.query(inputs_q)) / math.sqrt(Dh)
        k = heads(self.key(inputs_kv))
        v = heads(self.value(inputs_kv))
        w = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        return self.out((w @ v).transpose(1, 2).reshape(B, Nq, D))


class TransformerEncoderBlock(nn.Module):
    """Post-norm encoder layer with ReLU:
    ``x = LN(x + SelfAttn(x)); x = LN(x + W2 relu(W1 x))``."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, *, dtype=torch.float32):
        super().__init__()
        self.self_attn = MultiHeadDotProductAttention(d_model, num_heads, dtype=dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        self.linear1 = nn.Linear(d_model, d_ff, dtype=dtype)
        self.linear2 = nn.Linear(d_ff, d_model, dtype=dtype)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x, x))
        return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))


class PreNormBlock(nn.Module):
    """Pre-norm ViT block: ``x += SelfAttn(LN(x)); x += W2 gelu(W1 LN(x))``.

    ``use_flash`` picks ``FlashSelfAttention`` over ``MultiHeadDotProductAttention``
    (the same parameters, both named ``self_attn``); ``gelu_approximate`` the tanh GELU
    over the exact erf one.
    """

    def __init__(
        self,
        d_model: int,
        num_heads: int,
        d_ff: int,
        *,
        use_flash: bool = False,
        gelu_approximate: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.use_flash = use_flash
        self.gelu = "tanh" if gelu_approximate else "none"
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        if use_flash:
            self.self_attn = FlashSelfAttention(d_model, num_heads, dtype=dtype)
        else:
            self.self_attn = MultiHeadDotProductAttention(d_model, num_heads, dtype=dtype)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        self.mlp_in = nn.Linear(d_model, d_ff, dtype=dtype)
        self.mlp_out = nn.Linear(d_ff, d_model, dtype=dtype)

    def forward(self, x):
        h = self.norm1(x)
        x = x + (self.self_attn(h) if self.use_flash else self.self_attn(h, h))
        h = F.gelu(self.mlp_in(self.norm2(x)), approximate=self.gelu)
        return x + self.mlp_out(h)


class CrossAttentionBlock(nn.Module):
    """Pre-norm cross-attention + MLP block; the MLP's GELU is flax's default tanh
    approximation."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, *, dtype=torch.float32):
        super().__init__()
        self.norm_q = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        self.norm_kv = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        self.cross_attn = MultiHeadDotProductAttention(d_model, num_heads, dtype=dtype)
        self.norm_mlp = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        self.mlp_in = nn.Linear(d_model, d_ff, dtype=dtype)
        self.mlp_out = nn.Linear(d_ff, d_model, dtype=dtype)

    def forward(self, q, kv):
        q = q + self.cross_attn(self.norm_q(q), self.norm_kv(kv))
        h = F.gelu(self.mlp_in(self.norm_mlp(q)), approximate="tanh")
        return q + self.mlp_out(h)


class ClassifierHead(nn.Module):
    """``[Dense → Norm → ReLU]* → Dense(num_classes)``; the last Dense runs in f32
    and gives f32 logits. Dropout is the identity at eval."""

    def __init__(
        self,
        in_features: int,
        hidden_dims: Sequence[int],
        num_classes: int,
        *,
        norm: str = "layer",
        dtype=torch.float32,
    ):
        super().__init__()
        self.depth = len(hidden_dims)
        self.norm_prefix = "ln" if norm == "layer" else "bn"
        for i, h in enumerate(hidden_dims):
            self.add_module(f"fc{i}", nn.Linear(in_features, h, dtype=dtype))
            self.add_module(f"{self.norm_prefix}{i}", norm_layer(norm, h, dtype=dtype))
            in_features = h
        self.out = nn.Linear(in_features, num_classes, dtype=torch.float32)

    def forward(self, x):
        for i in range(self.depth):
            fc = getattr(self, f"fc{i}")
            x = fc(x.to(fc.weight.dtype))
            x = torch.relu(getattr(self, f"{self.norm_prefix}{i}")(x))
        return self.out(x.float())
