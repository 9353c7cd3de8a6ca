"""The classifier sharded over the mesh's ``tp`` axis (tensor parallelism).

Counterpart of ``shard_params(..., tp_shard_classifier=True)`` in
``nbdt_tpu/parallel/mesh.py``, which places a ResNet's ``linear`` kernel
``[D, C]`` with its classes split over ``tp`` and leaves the bias
replicated. Under ``jit`` that placement leaves the math as it was; here
each tp rank holds its block of ``C / tp`` output rows of the ``[C, D]``
weight and the whole bias, computes its block of logit columns, and two
collectives over the tp group keep the rest of the step unchanged:

- forward: the logits' column blocks are all-gathered, so every rank holds
  the whole ``[B, C]`` logits (in rank order, then the bias added) before
  the loss and the tree;
- backward: each rank keeps its own columns of the logits' gradient for its
  weight block, and the features' gradient, a sum over every class, is
  all-reduced over tp.

Ranks of one dp index and different tp index hold the same rows, so their
backbones see the same features and get the same gradients.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F


class _SumGradOverTP(torch.autograd.Function):
    """Identity forward; the gradient is summed over the tp group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _GatherColumns(torch.autograd.Function):
    """``[B, C / tp]`` blocks -> ``[B, C]`` in tp rank order; the gradient
    back to this rank's block."""

    @staticmethod
    def forward(ctx, local, group, rank, world):
        ctx.rank, ctx.width = rank, local.shape[1]
        blocks = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(blocks, local.contiguous(), group=group)
        return torch.cat(blocks, dim=1)

    @staticmethod
    def backward(ctx, dy):
        return dy[:, ctx.rank * ctx.width:(ctx.rank + 1) * ctx.width], None, None, None


class ColumnShardedLinear(nn.Module):
    """This tp rank's block of an ``nn.Linear(D, C)``: ``weight [C / tp,
    D]``, rows ``rank * C / tp`` on, and the whole ``bias [C]``; the forward
    returns the whole ``[B, C]`` logits on every rank of ``group``."""

    def __init__(self, linear: nn.Linear, group, rank: int, world: int):
        super().__init__()
        C = linear.out_features
        if C % world:
            raise ValueError(f"the classifier's {C} classes do not divide over tp={world}")
        self.in_features, self.out_features = linear.in_features, C
        self.group, self.rank, self.world = group, rank, world
        rows = slice(rank * C // world, (rank + 1) * C // world)
        self.weight = nn.Parameter(linear.weight.detach()[rows].clone())
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        local = F.linear(_SumGradOverTP.apply(x, self.group), self.weight)
        logits = _GatherColumns.apply(local, self.group, self.rank, self.world)
        return logits if self.bias is None else logits + self.bias

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"shard {self.rank} of {self.world}")


def shard_classifier(model: nn.Module, group, rank: int, world: int) -> list:
    """Replaces the head of every ResNet in ``model`` (``linear`` on the
    CIFAR ResNets, ``fc`` on torchvision's: the modules the JAX package
    names ``linear``) by its :class:`ColumnShardedLinear`, in place, as
    the JAX package shards only kernels under ``linear``; the other
    backbones' heads stay whole. Returns the qualified names sharded."""
    from ..models.resnet import ResNet

    sharded = []
    for name, module in list(model.named_modules()):
        if isinstance(module, ResNet):
            head = getattr(module, module.head_name)
            if isinstance(head, nn.Linear):
                setattr(module, module.head_name,
                        ColumnShardedLinear(head, group, rank, world))
                sharded.append(".".join(filter(None, (name, module.head_name))))
    return sharded
