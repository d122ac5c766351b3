"""Shared building blocks with flax semantics (``tpuhar/models/layers.py``).

Each module's attribute names are its flax submodule names, so ``bridge`` maps a
flax variable tree onto it by name. Modules take the compute ``dtype`` at
construction, as flax modules do; LayerNorm eps is flax's 1e-6, BatchNorm's 1e-5.

Training (``train=True``) follows flax's train mode: BatchNorm normalizes with the
batch's statistics and updates its running ones, and dropout draws its masks from an
explicit ``torch.Generator`` (``dropout``). Inside a data-parallel scope
(``parallel.scope``) both are global: BatchNorm's moments are those of the global batch,
and a dropout mask over the batch is this rank's rows of the global batch's mask. Split
over the mesh's model axis (``parallel.mesh.shard_params``), the attention holds its
rank's heads and the blocks' MLPs their rank's hidden units (``split_over_model``):
column-parallel in, row-parallel out (``scope.copy_to_model``, ``scope.row_parallel``),
a dropout mask on the split hidden units this rank's columns of the whole width's. A
module whose heads or hidden width do not divide stays whole. For training, parameters
are kept as f32 leaves and cast to the dtype each module was built in at use
(``models.crossmodal.CrossModalModel.forward_cast``), as flax casts its f32 parameters
to ``dtype``; the serving forwards build the modules in the compute dtype and cast
nothing.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import FlashSelfAttention, SplitHeads, head_projections
from ..parallel import scope

LN_EPS = 1e-6  # flax nn.LayerNorm default (torch's is 1e-5)
BN_EPS = 1e-5


BN_MOMENTUM = 0.9  # flax nn.BatchNorm(momentum=0.9): ra = 0.9·ra + 0.1·batch


def dropout(x: torch.Tensor, rate: float, generator=None, shape=None, cols=None) -> torch.Tensor:
    """flax's dropout: keep each element with probability ``1 − rate`` and scale the
    kept ones by ``1/(1 − rate)``; the mask is drawn from ``generator`` in ``shape`` and
    broadcast over ``x``. Without ``shape`` the mask is ``x``'s, batch first: in a
    data-parallel scope, this rank's rows of the global batch's mask, and with ``cols``
    (a ``ModelShard``: ``x``'s last dimension is split over the model axis) this rank's
    columns of the whole width's. A ``shape`` given is a mask shared over the batch,
    drawn the same on every rank. The mask is drawn on the generator's device and moved
    to ``x``'s: a CPU generator gives a CUDA step the masks it gives a CPU step."""
    if rate <= 0.0:
        return x

    def draw(size):
        on = x.device if generator is None else generator.device
        return torch.rand(size, generator=generator, device=on).to(x.device)

    keep = (draw(shape) if shape is not None else scope.draw_rows(draw, x.shape, cols)) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax's variable names: params
    ``scale``/``bias``, running stats ``mean``/``var``. Applied in f32, or in float64
    for float64 input, as flax promotes to at least f32.

    ``train=True`` is flax's train mode: the batch's mean and biased variance over every
    axis but the last, in f32 as E[x²] − E[x]² (clipped at 0), normalize ``x``, and the
    running stats move to ``0.9·ra + 0.1·batch`` (the biased variance; torch's
    ``BatchNorm1d`` keeps the unbiased one). In a data-parallel scope E[x] and E[x²] are
    the global batch's: the mean over the ranks of theirs (each holds an equal share)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(features), requires_grad=False)
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))

    def forward(self, x, *, train: bool = False):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            axes = tuple(range(xf.dim() - 1))
            mean, sq = xf.mean(dim=axes), xf.square().mean(dim=axes)
            shard = scope.current()
            if shard is not None:
                mean, sq = scope.mean_over(torch.stack([mean, sq]), shard).unbind(0)
            var = torch.clamp(sq - mean.square(), min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1.0 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        s = self.scale.to(xf.dtype) * torch.rsqrt(var.to(xf.dtype) + BN_EPS)
        return ((xf - mean.to(xf.dtype)) * s + self.bias.to(xf.dtype)).to(x.dtype)


def norm_layer(kind: str, features: int, *, dtype=torch.float32) -> nn.Module:
    """Head norm selector: "layer" (LayerNorm) or "batch" (eval BatchNorm)."""
    if kind == "layer":
        return nn.LayerNorm(features, eps=LN_EPS, dtype=dtype)
    if kind == "batch":
        return BatchNorm(features)
    raise ValueError(f"Unknown norm kind: {kind}")


class MultiHeadDotProductAttention(SplitHeads):
    """``flax.linen.MultiHeadDotProductAttention``: q/k/v ``DenseGeneral`` to
    ``(H, Dh)`` with per-head bias, the query scaled by ``1/sqrt(Dh)`` before the dot, a
    softmax over keys (in f32), and an ``out`` ``DenseGeneral`` back to D. With
    ``train=True`` and a ``dropout_rate``, the attention weights go through flax's
    ``broadcast_dropout``: one ``(Nq, Nk)`` mask shared over batch and heads."""

    def __init__(self, d_model: int, num_heads: int, *, dropout_rate: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, d_model // num_heads
        self.dropout_rate = dropout_rate
        self.query, self.key, self.value, self.out = head_projections(d_model, num_heads, dtype=dtype)

    def forward(self, inputs_q, inputs_kv, *, train: bool = False, generator=None):
        B, Nq, _ = inputs_q.shape
        H, Dh = self.num_heads, self.head_dim
        same = inputs_kv is inputs_q
        inputs_q = scope.copy_to_model(inputs_q, self.tp)
        inputs_kv = inputs_q if same else scope.copy_to_model(inputs_kv, self.tp)

        def heads(t):  # (B, N, H·Dh) → (B, H, N, Dh)
            return t.view(B, t.shape[1], H, Dh).transpose(1, 2)

        q = heads(self.query(inputs_q)) / math.sqrt(Dh)
        k = heads(self.key(inputs_kv))
        v = heads(self.value(inputs_kv))
        w = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        if train:  # shared over the heads: every model rank draws the same mask
            w = dropout(w, self.dropout_rate, generator, shape=(1, 1, *w.shape[-2:]))
        return scope.row_parallel(self.out, (w @ v).transpose(1, 2).reshape(B, Nq, H * Dh), self.tp)


class _SplitMLP(nn.Module):
    """A block whose MLP of ``d_ff`` hidden units (``linear1``/``mlp_in`` →
    ``linear2``/``mlp_out``) may be split over the model axis: ``mlp_tp`` is its
    ``ModelShard`` once ``split_over_model`` sees its first dense hold a block of them."""

    mlp_tp = None

    def split_over_model(self, shard) -> None:
        first = self.linear1 if hasattr(self, "linear1") else self.mlp_in
        if first.out_features < self.d_ff:
            self.mlp_tp = shard


class TransformerEncoderBlock(_SplitMLP):
    """Post-norm encoder layer with ReLU:
    ``x = LN(x + Drop(SelfAttn(x))); x = LN(x + Drop(W2 Drop(relu(W1 x))))``; the
    dropouts (and the attention weights' one) act only with ``train=True``."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, *, dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.dropout_rate, self.d_ff = dropout, d_ff
        self.self_attn = MultiHeadDotProductAttention(d_model, num_heads, dropout_rate=dropout, dtype=dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        self.linear1 = nn.Linear(d_model, d_ff, dtype=dtype)
        self.linear2 = nn.Linear(d_ff, d_model, dtype=dtype)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)

    def forward(self, x, *, train: bool = False, generator=None):
        rate = self.dropout_rate if train else 0.0
        attn = dropout(self.self_attn(x, x, train=train, generator=generator), rate, generator)
        x = self.norm1(x + attn)
        h = dropout(torch.relu(self.linear1(scope.copy_to_model(x, self.mlp_tp))), rate, generator, cols=self.mlp_tp)
        return self.norm2(x + dropout(scope.row_parallel(self.linear2, h, self.mlp_tp), rate, generator))


class PreNormBlock(_SplitMLP):
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
        self.use_flash, self.d_ff = use_flash, d_ff
        self.gelu = "tanh" if gelu_approximate else "none"
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        if use_flash:
            self.self_attn = FlashSelfAttention(d_model, num_heads, dtype=dtype)
        else:
            self.self_attn = MultiHeadDotProductAttention(d_model, num_heads, dtype=dtype)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        self.mlp_in = nn.Linear(d_model, d_ff, dtype=dtype)
        self.mlp_out = nn.Linear(d_ff, d_model, dtype=dtype)

    def forward(self, x, *, train: bool = False):
        """``train`` changes nothing: the ViT's blocks have no dropout (flax's
        ``VideoViT`` builds them with rate 0) and no BatchNorm."""
        h = self.norm1(x)
        x = x + (self.self_attn(h) if self.use_flash else self.self_attn(h, h))
        h = F.gelu(self.mlp_in(scope.copy_to_model(self.norm2(x), self.mlp_tp)), approximate=self.gelu)
        return x + scope.row_parallel(self.mlp_out, h, self.mlp_tp)


class CrossAttentionBlock(_SplitMLP):
    """Pre-norm cross-attention + MLP block; the MLP's GELU is flax's default tanh
    approximation. With ``train=True`` and a ``dropout`` rate, dropout acts on the
    attention weights (``MultiHeadDotProductAttention``'s) and on both branches before
    their residual adds, its masks drawn from ``generator``."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, *, dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.dropout_rate, self.d_ff = dropout, d_ff
        self.norm_q = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        self.norm_kv = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        self.cross_attn = MultiHeadDotProductAttention(d_model, num_heads, dropout_rate=dropout, dtype=dtype)
        self.norm_mlp = nn.LayerNorm(d_model, eps=LN_EPS, dtype=dtype)
        self.mlp_in = nn.Linear(d_model, d_ff, dtype=dtype)
        self.mlp_out = nn.Linear(d_ff, d_model, dtype=dtype)

    def forward(self, q, kv, *, train: bool = False, generator=None):
        rate = self.dropout_rate if train else 0.0
        h = self.cross_attn(self.norm_q(q), self.norm_kv(kv), train=train, generator=generator)
        q = q + dropout(h, rate, generator)
        h = F.gelu(self.mlp_in(scope.copy_to_model(self.norm_mlp(q), self.mlp_tp)), approximate="tanh")
        return q + dropout(scope.row_parallel(self.mlp_out, h, self.mlp_tp), rate, generator)


class ProjectionHead(nn.Module):
    """Contrastive projection head: ``Dense → Norm → ReLU → Dense`` (flax's
    ``ProjectionHead``); the norm is BatchNorm (``bn``, train mode with ``train=True``) or
    LayerNorm (``ln``)."""

    def __init__(self, in_features: int, hidden_dim: int, out_dim: int, *, norm: str = "batch", dtype=torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_dim, dtype=dtype)
        self.norm_name = "bn" if norm == "batch" else "ln"
        self.add_module(self.norm_name, norm_layer(norm, hidden_dim, dtype=dtype))
        self.fc2 = nn.Linear(hidden_dim, out_dim, dtype=dtype)

    def forward(self, x, *, train: bool = False):
        x = self.fc1(x.to(self.fc1.weight.dtype))
        norm = getattr(self, self.norm_name)
        x = norm(x, train=train) if isinstance(norm, BatchNorm) else norm(x)
        return self.fc2(torch.relu(x))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(‖x‖, eps)`` along ``dim`` (``torch.nn.functional.normalize``'s
    semantics, as flax's ``l2_normalize``)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


class ClassifierHead(nn.Module):
    """``[Dense → Norm → ReLU → Dropout]* → Dense(num_classes)``; the last Dense runs in
    f32 and gives f32 logits. The norm is LayerNorm (``ln{i}``) or BatchNorm (``bn{i}``,
    train mode with ``train=True``); dropout acts only with ``train=True``, its masks
    drawn from ``generator``."""

    def __init__(
        self,
        in_features: int,
        hidden_dims: Sequence[int],
        num_classes: int,
        *,
        dropout: float = 0.0,
        norm: str = "layer",
        dtype=torch.float32,
    ):
        super().__init__()
        self.depth = len(hidden_dims)
        self.dropout_rate = dropout
        self.norm_prefix = "ln" if norm == "layer" else "bn"
        for i, h in enumerate(hidden_dims):
            self.add_module(f"fc{i}", nn.Linear(in_features, h, dtype=dtype))
            self.add_module(f"{self.norm_prefix}{i}", norm_layer(norm, h, dtype=dtype))
            in_features = h
        self.out = nn.Linear(in_features, num_classes, dtype=torch.float32)

    def forward(self, x, *, train: bool = False, generator=None):
        for i in range(self.depth):
            fc = getattr(self, f"fc{i}")
            x = fc(x.to(fc.weight.dtype))
            norm = getattr(self, f"{self.norm_prefix}{i}")
            x = torch.relu(norm(x, train=train) if isinstance(norm, BatchNorm) else norm(x))
            if train:
                x = dropout(x, self.dropout_rate, generator)
        return self.out(x.float())
