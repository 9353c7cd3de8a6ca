"""Mesh construction and data-parallel placement.

Counterpart of ``nbdt_tpu/parallel/mesh.py``. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of shape ``(dp, tp)`` named
``("dp", "tp")``. One process drives one card, so a mesh over N cards is N
processes (``torchrun --nproc-per-node N -m nbdt_torch.main --multihost``):
where JAX's single process spans every local chip, here each rank holds its
own dp rows and DDP all-reduces the gradients. With ``tp > 1``,
``shard_params(..., tp_shard_classifier=True)`` splits a ResNet's classes
over the tp ranks (:mod:`nbdt_torch.parallel.tp`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils import resolve_device


def mesh_shape(n: int, dp: Optional[int] = None, tp: int = 1) -> Tuple[int, int]:
    """``(dp, tp)`` of a mesh over ``n`` devices, with JAX's checks."""
    if dp is None:
        if n % tp:
            raise AssertionError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise AssertionError(f"dp({dp}) * tp({tp}) != devices({n})")
    return dp, tp


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1,
              device="cuda") -> DeviceMesh:
    """A ``(dp, tp)`` mesh over the process group's ranks, one card each.

    With no process group up, forms a one-rank group on an in-process store
    (NCCL on a card, gloo on the CPU), so that ``--mesh`` runs on one card as
    JAX's does on one chip. ``n_devices`` defaults to the world size and
    must equal it: a rank drives one device, so a mesh over fewer devices
    than ranks has no counterpart.
    """
    device = resolve_device(device)
    if device.type == "cuda":  # bind the card before NCCL's communicator forms
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    shape = mesh_shape(n, dp, tp)
    if n != world:
        raise ValueError(f"a mesh over {n} devices needs {n} processes, one per device; the "
                         f"process group has {world}")
    return init_device_mesh(device.type, shape, mesh_dim_names=("dp", "tp"))


def dp_rows(mesh: DeviceMesh, batch: int) -> slice:
    """This rank's rows of a global batch sharded over ``dp``: the
    ``r``-th of ``dp`` equal blocks, JAX's row order. Raises when the batch
    does not divide by the dp extent."""
    dp = mesh.size(0)
    if batch % dp:
        raise ValueError(f"the global size of dimension 0 should be divisible by {dp} (the dp "
                         f"extent), but it is equal to {batch}")
    n = batch // dp
    r = mesh.get_local_rank("dp")
    return slice(r * n, (r + 1) * n)


def shard_batch(mesh: DeviceMesh, *arrays):
    """This rank's dp slice of each host-global array, on its device. Every
    process passes the same global batch."""
    out = []
    for a in arrays:
        a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        out.append(a[dp_rows(mesh, a.shape[0])].to(mesh.device_type))
    return tuple(out) if len(out) > 1 else out[0]


def shard_params(mesh: DeviceMesh, model: torch.nn.Module,
                 tp_shard_classifier: bool = False) -> torch.nn.Module:
    """Replicate ``model`` over the mesh: every parameter and buffer is
    broadcast from global rank 0 (in place), so each rank starts from rank
    0's weights. ``tp_shard_classifier``: then each ResNet head (the JAX
    package's ``linear`` kernels, and nothing else) is split over the
    mesh's ``tp`` axis by :func:`~nbdt_torch.parallel.tp.shard_classifier`;
    at ``tp=1`` it stays whole."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            flat = t.data.contiguous()  # a channels-last weight is sent as a dense copy
            dist.broadcast(flat, src=0)
            if flat is not t.data:
                t.data.copy_(flat)
    tp = mesh.size(1)
    if tp_shard_classifier and tp > 1:
        from .tp import shard_classifier

        shard_classifier(model, mesh.get_group("tp"), mesh.get_local_rank("tp"), tp)
    return model
