"""Multi-process bootstrap and per-rank array placement.

Counterpart of ``nbdt_tpu/parallel/distributed.py``. Where JAX runs one SPMD
program per host over every local chip, the port runs one process per card:
``initialize_multihost`` forms the ``torch.distributed`` process group (NCCL
between cards, gloo on the CPU), and each rank feeds its own slice of the
global batch. A run over N cards is N processes, e.g.

    torchrun --nproc-per-node N -m nbdt_torch.main --multihost ...

Host-side contract, as in JAX: every process runs the same program; each
loads its own rows of the batch (``process_local_batch``), and replicated
arrays (weights, tree constants) are placed from every process's own full
copy (``host_array``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import resolve_device


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``, ``file://``,
    ``env://``) passes through."""
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> int:
    """Join (or form) the process group; returns the world size.

    Arguments fall back to ``NBDT_COORDINATOR`` / ``NBDT_NUM_PROCESSES`` /
    ``NBDT_PROCESS_ID``, then to ``torchrun``'s ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` (the counterpart of jax's automatic
    detection). A ``host:port`` address becomes ``tcp://host:port``; a
    ``file://`` URL passes through. ``backend`` defaults to ``nccl`` where
    there is a card and ``gloo`` elsewhere; ``gloo`` on a card is allowed
    (two ranks sharing one card: NCCL refuses that). With a card, the rank's
    device becomes ``cuda:LOCAL_RANK`` (else ``cuda:rank % device_count``).
    Idempotent: a second call is a no-op. A group that cannot form raises;
    nothing falls back to one process.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("NBDT_COORDINATOR")
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = env.get("NBDT_NUM_PROCESSES", env.get("WORLD_SIZE"))
    if process_id is None:
        process_id = env.get("NBDT_PROCESS_ID", env.get("RANK"))
    missing = [name for name, v in (("coordinator_address", coordinator_address),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"initialize_multihost: no {', '.join(missing)} given and none in "
                         "NBDT_COORDINATOR/NBDT_NUM_PROCESSES/NBDT_PROCESS_ID or torchrun's "
                         "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK")
    world, rank = int(num_processes), int(process_id)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        local = env.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=world, rank=rank)
    return dist.get_world_size()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def host_array(a, device="cuda") -> torch.Tensor:
    """A replicated host array (weights, tree constants) on this rank's
    device: every process holds the same full array and places its own
    copy."""
    return torch.as_tensor(np.asarray(a)).to(resolve_device(device))


def local_data(arr) -> np.ndarray:
    """This rank's rows of a batch-sharded step output (eval logits), in
    order, as numpy: a rank's tensors hold its own rows only."""
    if torch.is_tensor(arr):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def process_local_batch(local, device="cuda") -> torch.Tensor:
    """This rank's slice of the global batch on its device. Each rank's
    loader yields ``batch_size / world`` samples; the global batch is the
    concatenation over ranks in rank order, as in JAX, and never exists on
    one device."""
    return host_array(local, device)
