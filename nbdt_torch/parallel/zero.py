"""ZeRO-1: the optimizer's momentum partitioned over the data-parallel axis.

Counterpart of ``nbdt_tpu/parallel/zero.py``, through
``torch.distributed.optim.ZeroRedundancyOptimizer``: parameters stay
replicated (every rank's forward needs them), and each rank keeps the SGD
momentum of its own share of the parameters, updates that share after
DDP's gradient all-reduce and broadcasts it to the others. The math is the
one-process SGD's. The layout is not JAX's: JAX shards each momentum
buffer's largest axis divisible by dp (small leaves replicate); ZeRO gives
each rank whole parameters, balanced by size.
"""

from __future__ import annotations

from typing import List

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer


def shard_opt_state(mesh, optimizer: torch.optim.Optimizer) -> ZeroRedundancyOptimizer:
    """A ZeRO-1 form of ``optimizer`` over the mesh's ``dp`` group: the same
    class, parameters and hyperparameters (one parameter group), with the
    state partitioned over the ranks. Learning rates set on its
    ``param_groups`` reach every rank's local optimizer at each ``step``."""
    if len(optimizer.param_groups) != 1:
        raise ValueError("shard_opt_state: one parameter group expected, got "
                         f"{len(optimizer.param_groups)}")
    group = dict(optimizer.param_groups[0])
    params = group.pop("params")
    return ZeroRedundancyOptimizer(params, optimizer_class=type(optimizer),
                                   process_group=mesh.get_group("dp"), **group)


def zero_sharding(optimizer: ZeroRedundancyOptimizer) -> List[int]:
    """Indices (in the order of ``optimizer.param_groups``) of the
    parameters whose state this rank holds and updates."""
    index = {id(p): i for g in optimizer.param_groups for i, p in enumerate(g["params"])}
    return sorted(index[id(p)] for g in optimizer.optim.param_groups for p in g["params"])


def state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of optimizer state this rank holds (the momentum buffers)."""
    opt = getattr(optimizer, "optim", optimizer)
    return sum(v.numel() * v.element_size() for s in opt.state.values() for v in s.values()
               if torch.is_tensor(v))
