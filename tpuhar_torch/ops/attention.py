"""The flash self-attention module (``tpuhar/ops/attention.py``).

Both of the JAX package's flash kernels (``flash_mha(kernel="lean")``, its
``ops/flash_lean``, and ``kernel="library"``, the stock Pallas TPU kernel) compute one
function, and the port serves both with ``ops.flash_lean``: the Hopper kernel on a CUDA
tensor, its plain version on a CPU tensor. Attention without flash is the existing
``layers.MultiHeadDotProductAttention``, which ``PreNormBlock`` picks itself.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..parallel import scope
from .flash_lean import FlashLean, flash_lean


def head_projections(d_model: int, num_heads: int, *, dtype=torch.float32) -> Tuple[nn.Linear, ...]:
    """flax's attention projections as ``nn.Linear``: ``query``/``key``/``value``
    ``DenseGeneral`` D → (H, Dh) and ``out`` (H, Dh) → D. ``flax_shapes`` names each
    flax leaf's shape for ``bridge.init_params``."""
    if d_model % num_heads:
        raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
    dh = d_model // num_heads
    qkv = []
    for _ in range(3):
        dense = nn.Linear(d_model, d_model, dtype=dtype)
        dense.flax_shapes = {"kernel": (d_model, num_heads, dh), "bias": (num_heads, dh)}
        qkv.append(dense)
    out = nn.Linear(d_model, d_model, dtype=dtype)
    out.flax_shapes = {"kernel": (num_heads, dh, d_model)}
    return (*qkv, out)


class SplitHeads(nn.Module):
    """An attention with flax's ``query``/``key``/``value``/``out`` projections over
    ``num_heads`` heads of ``head_dim``, which ``parallel.mesh.shard_params`` may split
    over the model axis: ``split_over_model`` then makes it compute this rank's heads
    (``query`` holds ``H/tp`` of them, ``out`` their input columns) and issue the
    collectives over ``tp``, its ``ModelShard``."""

    tp = None

    def split_over_model(self, shard) -> None:
        if self.query.out_features < self.num_heads * self.head_dim:
            self.num_heads, self.tp = self.query.out_features // self.head_dim, shard


class FlashSelfAttention(SplitHeads):
    """Self-attention through ``flash_lean`` (the flash kernel); the parameters are those of
    flax's ``MultiHeadDotProductAttention`` (``query``/``key``/``value``/``out``).

    The projections stay in their ``(B, N, H·Dh)`` layout: the heads are strided
    views, the kernel reads them as they are and writes ``(B, N, H, Dh)``, so no
    transposing copy surrounds it. With grad enabled the attention goes through
    ``FlashLean`` (the forward also stores each row's log-sum-exp, and the backward runs
    the dK/dV and dQ kernels); under ``no_grad`` or ``inference_mode`` through
    ``flash_lean``, which stores nothing more.

    Split over the mesh's model axis it computes this rank's ``H/tp`` heads: the kernels
    read them as strided views of the local ``(B, N, H/tp·Dh)`` projections, and the
    output projection is row-parallel (``parallel.scope``).
    """

    def __init__(self, d_model: int, num_heads: int, *, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, d_model // num_heads
        self.query, self.key, self.value, self.out = head_projections(d_model, num_heads, dtype=dtype)

    def forward(self, x):
        B, N, _ = x.shape
        H, Dh = self.num_heads, self.head_dim
        x = scope.copy_to_model(x, self.tp)

        def heads(t):  # (B, N, H·Dh) → a (B, H, N, Dh) view
            return t.view(B, N, H, Dh).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        if torch.is_grad_enabled():
            ctx = FlashLean.apply(q, k, v, 1.0 / Dh ** 0.5)
        else:
            ctx = flash_lean(q, k, v)
        return scope.row_parallel(self.out, ctx.transpose(1, 2).reshape(B, N, H * Dh), self.tp)
