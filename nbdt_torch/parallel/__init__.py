"""Data parallelism over processes, one card each.

Counterpart of ``nbdt_tpu/parallel``. JAX expresses it as shardings over a
mesh; the port as ``torch.distributed``: ``initialize_multihost`` forms the
process group (NCCL between cards, gloo on the CPU), ``make_mesh`` a
``DeviceMesh`` of shape ``(dp, tp)``, the trainer wraps the model in DDP
with :class:`CrossRankBatchNorm2d` for flax's global-batch statistics, and
``shard_opt_state`` is ZeRO-1. JAX's ``batch_sharding`` and ``replicate``
are sharding objects with no counterpart here: a rank holds its dp rows
(``shard_batch``, ``process_local_batch``) and a full copy of the weights
(``shard_params``, ``host_array``), but for a ResNet's classifier, which
``shard_params(..., tp_shard_classifier=True)`` splits over ``tp``
(:class:`ColumnShardedLinear`).
"""

from .mesh import dp_rows, make_mesh, mesh_shape, shard_batch, shard_params
from .distributed import (
    host_array,
    initialize_multihost,
    is_multiprocess,
    local_data,
    process_local_batch,
)
from .syncbn import CrossRankBatchNorm2d, convert_batchnorm
from .tp import ColumnShardedLinear, shard_classifier
from .zero import shard_opt_state, state_bytes, zero_sharding
