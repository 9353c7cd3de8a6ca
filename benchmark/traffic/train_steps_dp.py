"""Data-parallel training steps back to back, one process a card: the step
that ``nbdt_torch.trainer.Trainer(mesh=make_mesh())`` builds, which is
what ``--mesh`` and ``--multihost`` run. It is wired as ``Trainer.__init__``
and ``Trainer._ddp`` wire it: the model's BatchNorms become
``CrossRankBatchNorm2d`` over the mesh's dp group, DDP wraps the model and
all-reduces the gradients, and ``make_train_step(..., cached=True,
forward=<DDP>, group=<dp>, rows=dp_rows(mesh, batch))`` draws the whole
global batch of ``batch`` rows (indices and augment) on every rank and
trains each on its own rows of it, with the loss averaged over the ranks.

Set-up is ``train_steps.py``'s with this step in the program's place:
every rank holds the seeded uint8 store of ``store_images`` images, draws
the same permutations and augment from the seed, and drives the step
through its first ``checked_steps`` steps. The window goes on from
there, for as many steps on every rank as rank 0's clock allows (learnt
two steps late, so that no host waits for it), and ends in a synchronize
and a barrier. ``host_step_ms``: the median
host milliseconds of rank 0's step calls, launch to return.

Check: ``train_steps.py``'s, on rank 0 alone (the reference follows the
checked steps on the whole global batch, on one card), of the loss
averaged over the ranks, the first gradient and the parameters' change as
rank 0 holds them; and, on every rank, ``replica_gap``: the largest
absolute difference of any parameter or buffer (the running statistics)
between this rank and rank 0 after the window, which data parallelism
keeps at nought.
"""

from __future__ import annotations

import statistics
import time

import torch
import torch.distributed as dist

from benchmark.harness import BENCH, free_memory, load_module, sync

train_steps = load_module(BENCH / "traffic" / "train_steps.py")
_mesh = None  # the program's mesh of this process, made by its first run


class MeshTrainer(train_steps.PortTrainer):
    """The program's data-parallel training step with its model and
    optimizer, on this rank's card."""

    def __init__(self, ctx, p: dict, jt):
        from torch.nn.parallel import DistributedDataParallel

        from nbdt_torch.parallel import convert_batchnorm, dp_rows, make_mesh
        from nbdt_torch.trainer import TrainConfig, lr_schedule, make_optimizer, make_train_step

        global _mesh
        if _mesh is None:  # one mesh a process: its groups are communicators
            _mesh = make_mesh(device=ctx.device)
        mesh = _mesh
        group = mesh.get_group("dp")
        opt = ctx.config["train"]
        self.model = ctx.program_model().to(ctx.device, memory_format=torch.channels_last)
        convert_batchnorm(self.model, group)
        ddp = DistributedDataParallel(
            self.model, device_ids=[ctx.device.index] if ctx.device.type == "cuda" else None,
            process_group=group, broadcast_buffers=False)
        cfg = TrainConfig(batch_size=p["batch"], lr=opt["lr"], momentum=opt["momentum"],
                          weight_decay=opt["weight_decay"], epochs=opt["epochs"])
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        norm = ctx.config["normalize"]
        self.step_fn = make_train_step(
            self.model, self.optimizer, lr_schedule(cfg, p["store_images"] // p["batch"]),
            train_steps.LOSS, jt, cached=True, batch_size=p["batch"],
            normalize=(norm["mean"], norm["std"]), crop_pad=p["crop_pad"], flip=True,
            forward=ddp, group=group, rows=dp_rows(mesh, p["batch"]))
        self.count = 0


def setup(ctx):
    return train_steps.setup(ctx, MeshTrainer)


def window(state, seconds: float, phases) -> dict:
    ctx = state["ctx"]
    p = ctx.params
    system, images, labels = state["system"], state["images"], state["labels"]
    per_epoch = p["store_images"] // p["batch"]
    step_i, steps, calls = state["step_i"], 0, []
    t0_ns, t0 = time.time_ns(), time.perf_counter()
    while ctx.running(t0, seconds):
        if step_i == per_epoch:
            a = time.time_ns()
            state["perm"] = torch.randperm(p["store_images"], generator=state["perm_gen"],
                                           device=images.device)
            step_i = 0
            phases.add(a, time.time_ns(), "new_epoch")
        a = time.time_ns()
        system.step(images, labels, state["perm"], step_i, state["aug"])
        b = time.time_ns()
        phases.add(a, b, "step_call")
        calls.append((b - a) / 1e6)
        step_i += 1
        steps += 1
    a = time.time_ns()
    sync(images.device)
    ctx.group.barrier()
    t1, t1_ns = time.perf_counter(), time.time_ns()
    phases.add(a, t1_ns, "end_sync")
    return {"t0_ns": t0_ns, "t1_ns": t1_ns, "window_s": t1 - t0, "attempted": steps,
            "failed": 0, "steps": steps, "train_images": steps * p["batch"],
            "host_step_ms": statistics.median(calls) if calls else None}


def replicated(system) -> dict:
    """What data parallelism keeps equal on every rank: the parameters and
    the buffers (the BatchNorms' running statistics, which no broadcast
    evens out: ``broadcast_buffers=False``)."""
    model = system.model if isinstance(system, MeshTrainer) else system.ref.model
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def replica_gap(tensors: dict) -> float:
    """The largest absolute difference of any element of ``tensors``
    between this rank and rank 0 (a collective: every rank calls it)."""
    mine = torch.cat([v.detach().reshape(-1).float() for v in tensors.values()])
    first = mine.clone()
    dist.broadcast(first, src=0)
    return float((mine - first).abs().max())


def check(state) -> dict:
    ctx = state["ctx"]
    gap = replica_gap(replicated(state["system"]))
    if ctx.rank == 0:
        checks = train_steps.check(state)
    else:
        state["system"] = None
        free_memory(ctx.device)
        checks = {}
    checks["replica_gap"] = (gap, ctx.cell["limits"]["replica_gap"])
    return checks
