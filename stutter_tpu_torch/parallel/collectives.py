"""The Megatron operators of tensor parallelism, as autograd Functions.

A tensor-parallel block takes its input whole on every rank of the model
group, runs its column-parallel products on the rank's output channels
(heads), and ends in a row-parallel product whose partial sums one
all-reduce adds up:
- ``copy_to_model`` marks where the replicated input enters the block: the
  identity forward, and an all-reduce of the gradient backward (each rank
  holds only its heads' share of it). It also marks replicated weights used
  inside the block (WavLM's gate and bucket table), whose gradients are
  likewise partial on each rank;
- ``reduce_from_model`` ends the block: an all-reduce forward, the identity
  backward.
``all_reduce_max`` and ``all_reduce_sum`` are the plain collectives the
int8 product needs (the per-token absmax, the int32 accumulators). Every
operator takes the group it runs on; ``group=None`` means no tensor
parallelism, and the operator is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y
