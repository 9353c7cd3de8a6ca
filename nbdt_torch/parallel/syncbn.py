"""BatchNorm over the global batch of a data-parallel mesh.

No JAX file matches this one: under ``jit`` an array sharded over ``dp`` is
one global array, so flax's ``BatchNorm`` already takes its batch mean and
variance over every rank's rows, and ``Trainer(mesh=...)`` on N devices
computes what the one-device trainer computes on the same global batch. Plain
DDP normalises each rank by its own rows, a different function; and
``nn.SyncBatchNorm`` runs on CUDA only. :class:`CrossRankBatchNorm2d` gives
flax's semantics on both devices:

- forward: each rank's per-channel ``[mean, biased variance, count]`` (f32)
  is all-gathered and combined (Chan's parallel formula), so every rank
  normalises by the same global statistics;
- backward: each rank's ``[sum dy, sum dy * x_hat]`` is all-reduced, so the
  input gradient is that of the sum of every rank's loss (DDP's gradient
  mean then gives the global mean's); the affine gradients stay local, and
  DDP all-reduces them with the rest;
- the running statistics take the global mean and the unbiased global
  variance (``n_global / (n_global - 1)``), as a plain BatchNorm does on the
  concatenated batch; every rank updates them alike.

The compute dtype follows the module's input, as the backbones' ``bn_impl``
sets it (f32, or the bf16 stream): statistics and normalisation in f32, the
output cast back to the input's dtype, as torch's own BatchNorm does. At
world size 1, in eval mode, or with no group, it is ``nn.BatchNorm2d``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn


def _channel_view(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


class _CrossRankNorm(torch.autograd.Function):
    """``(x, weight, bias) -> (y, mean, var)`` with global statistics;
    ``mean`` and the unbiased ``var`` come back for the running update."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, world):
        xf = x.float()
        C = x.shape[1]
        var_l, mean_l = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        count_l = torch.full_like(mean_l, xf.numel() // C)
        stats = torch.stack([mean_l, var_l, count_l])
        gathered = [torch.empty_like(stats) for _ in range(world)]
        dist.all_gather(gathered, stats, group=group)
        means, vars_, counts = torch.stack(gathered).unbind(1)  # [world, C] each
        n = counts.sum(0)
        mean = (means * counts).sum(0) / n
        var = ((vars_ + (means - mean) ** 2) * counts).sum(0) / n
        invstd = torch.rsqrt(var + eps)
        y = (xf - _channel_view(mean)) * _channel_view(invstd)
        if weight is not None:
            y = y * _channel_view(weight.float()) + _channel_view(bias.float())
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        unbiased = var * (n / (n - 1))
        ctx.mark_non_differentiable(mean, unbiased)
        return y.to(x.dtype), mean, unbiased

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dyf = dy.float()
        xhat = (x.float() - _channel_view(mean)) * _channel_view(invstd)
        sum_dy = dyf.sum((0, 2, 3))
        sum_dy_xhat = (dyf * xhat).sum((0, 2, 3))
        total = torch.stack([sum_dy, sum_dy_xhat])
        dist.all_reduce(total, group=ctx.group)  # every rank calls it, grads wanted or not
        scale = invstd if weight is None else invstd * weight.float()
        dx = (dyf - _channel_view(total[0] / n) - xhat * _channel_view(total[1] / n)) \
            * _channel_view(scale)
        dw = db = None
        if weight is not None:
            dw, db = sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype)
        return dx.to(x.dtype), dw, db, None, None, None


class CrossRankBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training statistics span every rank of
    ``group`` (the default group when None). Same parameters, buffers and
    state-dict keys as the module it replaces."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: Optional[float] = 0.1,
                 affine: bool = True, track_running_stats: bool = True, group=None,
                 device=None, dtype=None):
        super().__init__(num_features, eps, momentum, affine, track_running_stats,
                         device=device, dtype=dtype)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch_stats = self.training or self.running_mean is None
        world = dist.get_world_size(self.group) if dist.is_initialized() else 1
        if not batch_stats or world == 1:
            return super().forward(x)
        self._check_input_dim(x)
        y, mean, var = _CrossRankNorm.apply(x, self.weight, self.bias, self.eps, self.group,
                                            world)
        if self.training and self.track_running_stats:
            self.num_batches_tracked.add_(1)
            f = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                 else self.momentum)
            with torch.no_grad():
                self.running_mean.mul_(1 - f).add_(mean.to(self.running_mean.dtype), alpha=f)
                self.running_var.mul_(1 - f).add_(var.to(self.running_var.dtype), alpha=f)
        return y


def convert_batchnorm(model: nn.Module, group=None) -> nn.Module:
    """Swap every ``nn.BatchNorm2d`` of ``model`` for a
    :class:`CrossRankBatchNorm2d` over ``group``, in place, sharing its
    parameters and buffers: names and state-dict keys stay, so a
    checkpoint written under a mesh loads into the plain model and back.
    Returns ``model``."""
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, CrossRankBatchNorm2d):
                child.group = group
            elif isinstance(child, nn.BatchNorm2d):
                bn = CrossRankBatchNorm2d(child.num_features, child.eps, child.momentum,
                                          child.affine, child.track_running_stats, group,
                                          device="meta")
                bn.weight, bn.bias = child.weight, child.bias
                bn.running_mean, bn.running_var = child.running_mean, child.running_var
                bn.num_batches_tracked = child.num_batches_tracked
                bn.train(child.training)
                setattr(parent, name, bn)
            elif isinstance(child, nn.modules.batchnorm._BatchNorm):
                raise TypeError(f"convert_batchnorm: {type(child).__name__} at {name!r} has no "
                                "cross-rank form (BatchNorm2d only)")
    return model
