"""The scopes of a step over the mesh: the global view that JAX's sharded steps have.

Under a JAX mesh the sharded step computes the one-device step on the global batch
(GSPMD). A rank that holds only its rows computes that function only where every
quantity that spans rows is made global. Inside ``active(shard)``:

- ``layers.BatchNorm`` (train mode) all-reduces its moments (``mean_over``);
- ``layers.dropout`` and ``ops/augment`` draw for the global batch from the same
  generator on every rank and keep this rank's rows (``draw_rows``);
- the steps gather the contrastive embeddings (``gather_rows``), mask by global row
  index, scale each rank's loss so that the ranks' losses sum to the global one, and sum
  the gradients over the ranks (``all_reduce_grads``) before the optimizer clips them.

The collectives carry autograd, with the sum of the ranks' losses as the objective: the
backward of a sum over ranks all-reduces the gradient, the backward of a gather
all-reduces it and keeps this rank's rows. At a world of one process each is an identity.
Outside a scope (``current()`` is None) nothing changes. A data axis of one rank needs
no scope: the steps and the engine run such a batch whole, as without a mesh.

Over the mesh's model axis (``ModelShard``; tensor parallelism, Megatron-style) a module
whose parameters ``parallel.mesh.shard_params`` split holds the shard itself: the
attention's heads and the MLP's hidden units are column-parallel going in
(``copy_to_model``: the identity, its gradient all-reduced over the model group), the
attention's output projection and the MLP's second dense row-parallel going out
(``row_parallel``: the partial products all-reduced in f32, the bias added once after
the sum). A dropout mask over a split activation is this rank's rows and hidden columns
of the global tensor's mask (``draw_rows(..., cols=)``). The model shard rides on the
modules, so a remat recompute replays the same collectives in the same order on every
rank.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclass(frozen=True)
class DataShard:
    """This process's place on the mesh's data axis: ``rank`` of ``size``, over
    ``group``."""

    rank: int
    size: int
    group: object = None

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``size · n_local`` rows."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)


@dataclass(frozen=True)
class ModelShard:
    """This process's place on the mesh's model axis: ``rank`` of ``size``, over
    ``group``."""

    rank: int
    size: int
    group: object = None

    def block(self, n_local: int) -> slice:
        """This rank's block of a dimension of ``size · n_local`` split over the axis."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)


_ACTIVE: Optional[DataShard] = None  # process-wide: a remat recompute runs in the backward's thread


def current() -> Optional[DataShard]:
    return _ACTIVE


@contextlib.contextmanager
def active(shard: Optional[DataShard]):
    """Run the body (forward and backward) in ``shard``'s scope; ``None`` leaves the
    scope as it is."""
    global _ACTIVE
    before = _ACTIVE
    if shard is not None:
        _ACTIVE = shard
    try:
        yield shard
    finally:
        _ACTIVE = before


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(shard.size)]
        dist.all_gather(parts, x, group=shard.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.shard.group)
        return grad[ctx.shard.rows(grad.shape[0] // ctx.shard.size)], None


def sum_over(x: torch.Tensor, shard: DataShard) -> torch.Tensor:
    """``x`` summed over the ranks (autograd: the gradient all-reduced)."""
    return _SumOverRanks.apply(x, shard.group)


def mean_over(x: torch.Tensor, shard: DataShard) -> torch.Tensor:
    """The mean of ``x`` over the ranks: a global mean where each rank holds the mean of
    an equal share of the rows."""
    return sum_over(x, shard) / shard.size


def gather_rows(x: torch.Tensor, shard: DataShard) -> torch.Tensor:
    """The ranks' ``x`` stacked along the rows in rank order: the global batch's."""
    return _GatherRows.apply(x, shard)


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor], shape: Sequence[int],
              cols: Optional[ModelShard] = None) -> torch.Tensor:
    """``draw(shape)``, or in a scope this rank's rows of ``draw`` for the global batch
    (``shape[0]`` is the batch, or a batch-major flattening of it); with ``cols`` (the
    last dimension split over the model axis) this rank's block of the last dimension
    of the draw for the whole width. Every rank draws the same global tensor, so the
    generators advance alike."""
    shard = current()
    full = list(shape)
    if shard is not None:
        full[0] *= shard.size
    if cols is not None:
        full[-1] *= cols.size
    mask = draw(tuple(full))
    if shard is not None:
        mask = mask[shard.rows(shape[0])]
    if cols is not None:
        mask = mask[..., cols.block(shape[-1])]
    return mask


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """The input of a column-parallel product: ``x`` itself, whose gradient (each rank's
    from its columns) is summed over the model group in the backward."""
    return x if shard is None else _CopyToModel.apply(x, shard.group)


def row_parallel(linear: torch.nn.Module, x: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    """``linear(x)`` where ``linear`` holds this rank's block of input columns and ``x``
    the matching block of features: the partial products in f32, summed over the model
    group, the bias added once after the sum, then one rounding to ``x``'s dtype (the
    one-device GEMM accumulates in f32 and rounds once). ``linear(x)`` without a
    shard."""
    if shard is None:
        return linear(x)
    # the partials summed over the group; the gradient passes through to each
    y = _ReduceFromModel.apply(F.linear(x.float(), linear.weight.float()), shard.group)
    if linear.bias is not None:
        y = y + linear.bias.float()
    return y.to(x.dtype)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], shard: DataShard) -> None:
    """Sum each parameter's gradient over the ranks, in one all-reduce per dtype."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=shard.group)
        start = 0
        for g in grads:
            g.copy_(flat[start:start + g.numel()].view_as(g))
            start += g.numel()
