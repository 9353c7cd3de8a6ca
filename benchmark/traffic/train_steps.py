"""Training steps back to back: ``make_train_step(..., cached=True)`` of
``nbdt_torch.trainer`` with the tree-supervision loss ``SoftTreeSupLoss``
(the one that ``reference/train.py`` follows) over a device-resident uint8
store of ``store_images`` seeded 32px images and labels (each image its
class's seeded pattern plus as much noise, so that the loss falls as on
real data), ``batch`` rows a step, at the configuration's SGD settings. The
benchmark draws each epoch's permutation and hands the step its augment
generator, both from the seed; a new permutation starts each epoch.

Set-up builds the one training object (model, optimizer, step) and drives
it through its first ``checked_steps`` steps by the window's own call; the
window goes on from there. Check: the reference follows those steps from
the same weights, rows and draws. ``loss_gap``: each step's loss, relative
to the reference's; ``grad_gap``: the first step's gradient as the
optimizer got it (its momentum buffer less the weight decay), and
``change_gap``: each parameter's change over the checked steps, both by the
worst leaf, as the gap between the program's norm and the reference's over
the larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is under ``still_leaf`` of the median
leaf's are left out of both (they move by rounding alone).
"""

from __future__ import annotations

import copy
import time

import torch

from benchmark.harness import free_memory, precision, worst
from benchmark.reference import train as ref_train

LOSS = "SoftTreeSupLoss"


class PortTrainer:
    """The program's training step with its model and optimizer."""

    def __init__(self, ctx, p: dict, jt):
        from nbdt_torch.trainer import TrainConfig, lr_schedule, make_optimizer, make_train_step

        opt = ctx.config["train"]
        self.model = ctx.program_model().to(ctx.device, memory_format=torch.channels_last)
        cfg = TrainConfig(batch_size=p["batch"], lr=opt["lr"], momentum=opt["momentum"],
                          weight_decay=opt["weight_decay"], epochs=opt["epochs"])
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        norm = ctx.config["normalize"]
        self.step_fn = make_train_step(
            self.model, self.optimizer, lr_schedule(cfg, p["store_images"] // p["batch"]),
            LOSS, jt, cached=True, batch_size=p["batch"],
            normalize=(norm["mean"], norm["std"]), crop_pad=p["crop_pad"], flip=True)
        self.count = 0

    def step(self, images, labels, perm, step_i, gen):
        out = self.step_fn(images, labels, perm, step_i, gen, 1.0, 1.0, self.count)
        self.count += 1
        return out[0]["loss"]

    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def momentum(self) -> dict:
        return {name: self.optimizer.state.get(p, {}).get("momentum_buffer")
                for name, p in self.model.named_parameters()}


class ReferenceTrainer:
    """The control: the reference's step in TF32 behind the same calls."""

    def __init__(self, ctx, p: dict):
        opt = ctx.config["train"]
        model = copy.deepcopy(ctx.reference())  # the check's reference starts from the seed
        self.ref = ref_train.SoftTreeSupSGD(model, ctx.rules(), opt["lr"],
                                            opt["momentum"], opt["weight_decay"])
        self.p, self.norm = p, ctx.config["normalize"]

    def step(self, images, labels, perm, step_i, gen):
        B = self.p["batch"]
        idx = perm[step_i * B:(step_i + 1) * B]
        offsets, flips = ref_train.draws(gen, B, self.p["crop_pad"])
        x, y = ref_train.batch(images, labels, idx, offsets, flips, self.p["crop_pad"],
                               self.norm["mean"], self.norm["std"])
        with precision(True):
            loss, _ = self.ref.step(x, y)
        return loss

    def params(self) -> dict:
        return self.ref.params

    def momentum(self) -> dict:
        return dict(self.ref.buffers)


def snapshot(tensors: dict) -> dict:
    return {k: (None if v is None else v.detach().clone()) for k, v in tensors.items()}


def setup(ctx, program=PortTrainer):
    """The store, the draws and the one training object (``program``, or
    the control), driven through the checked steps."""
    p = ctx.params
    size = ctx.config["model"]["image_size"]
    gen, classes = ctx.generator("store"), ctx.config["model"]["num_classes"]
    labels = torch.randint(0, classes, (p["store_images"],), generator=gen, device=ctx.device)
    templates = torch.randn(classes, size, size, 3, generator=gen, device=ctx.device)
    noise = torch.randn(p["store_images"], size, size, 3, generator=gen, device=ctx.device)
    images = (128 + 40 * (templates[labels] + noise)).clamp_(0, 255).to(torch.uint8)
    perm_gen, aug = ctx.generator("permutation"), ctx.generator("augment")
    perm = torch.randperm(p["store_images"], generator=perm_gen, device=ctx.device)
    state = {"ctx": ctx, "images": images, "labels": labels, "perm": perm,
             "perm_gen": perm_gen, "aug": aug, "aug_start": aug.get_state(),
             "perm_start": perm.clone()}
    p0 = snapshot(dict(ctx.reference().named_parameters()))
    if ctx.variant == "control":
        system = ReferenceTrainer(ctx, p)
    else:
        from nbdt_torch.rules import to_device_tree

        system = program(ctx, p, to_device_tree(ctx.program_tree().arrays, ctx.device))
    losses, grads = [], None
    for k in range(p["checked_steps"]):  # the first steps, through the window's call
        losses.append(system.step(images, labels, perm, k, aug))
        if k == 0:
            wd = ctx.config["train"]["weight_decay"]
            grads = {n: (torch.zeros_like(p0[n]) if b is None else b - wd * p0[n])
                     for n, b in snapshot(system.momentum()).items()}
    state.update(system=system, p0=p0, losses=[float(x) for x in losses], grads=grads,
                 p_after=snapshot(system.params()), step_i=p["checked_steps"])
    return state


def window(state, seconds: float, phases) -> dict:
    p = state["ctx"].params
    system, images, labels = state["system"], state["images"], state["labels"]
    per_epoch = p["store_images"] // p["batch"]
    step_i, steps = state["step_i"], 0
    t0_ns, t0 = time.time_ns(), time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if step_i == per_epoch:
            a = time.time_ns()
            state["perm"] = torch.randperm(p["store_images"], generator=state["perm_gen"],
                                           device=images.device)
            step_i = 0
            phases.add(a, time.time_ns(), "new_epoch")
        a = time.time_ns()
        system.step(images, labels, state["perm"], step_i, state["aug"])
        phases.add(a, time.time_ns(), "step_call")
        step_i += 1
        steps += 1
    a = time.time_ns()
    if images.device.type == "cuda":
        torch.cuda.synchronize(images.device)
    t1, t1_ns = time.perf_counter(), time.time_ns()
    phases.add(a, t1_ns, "end_sync")
    return {"t0_ns": t0_ns, "t1_ns": t1_ns, "window_s": t1 - t0, "attempted": steps,
            "failed": 0, "steps": steps, "train_images": steps * p["batch"]}


def leaf_gap(mine: dict, theirs: dict, counted: list) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger of
    that leaf's reference norm and the median leaf's."""
    norms = {k: float(theirs[k].norm()) for k in counted}
    median = sorted(norms.values())[len(norms) // 2] if norms else 0.0
    gap = 0.0
    for k in counted:
        scale = max(norms[k], median)
        gap = worst(gap, abs(float(mine[k].norm()) - norms[k]) / scale if scale > 0 else 0.0)
    return gap


def check(state) -> dict:
    ctx, p = state["ctx"], state["ctx"].params
    limits = ctx.cell["limits"]
    state["system"] = None
    free_memory(ctx.device)
    ref = ref_train.SoftTreeSupSGD(ctx.reference(), ctx.rules(), ctx.config["train"]["lr"],
                                   ctx.config["train"]["momentum"],
                                   ctx.config["train"]["weight_decay"])
    gen = torch.Generator(device=ctx.device)
    gen.set_state(state["aug_start"])
    B, perm = p["batch"], state["perm_start"]
    losses, grads = [], None
    with precision(False):
        for k in range(p["checked_steps"]):
            offsets, flips = ref_train.draws(gen, B, p["crop_pad"])
            x, y = ref_train.batch(state["images"], state["labels"], perm[k * B:(k + 1) * B],
                                   offsets, flips, p["crop_pad"], ctx.config["normalize"]["mean"],
                                   ctx.config["normalize"]["std"])
            loss, g = ref.step(x, y)
            losses.append(float(loss))
            grads = g if k == 0 else grads
    gnorm = {k: float(v.norm()) for k, v in grads.items()}
    median = sorted(gnorm.values())[len(gnorm) // 2]
    counted = [k for k, v in gnorm.items() if v >= p["still_leaf"] * median]
    change_ref = {k: ref.params[k].detach() - state["p0"][k] for k in counted}
    change = {k: state["p_after"][k] - state["p0"][k] for k in counted}
    loss_gap = worst(0.0, *(abs(a - b) / abs(b) for a, b in zip(state["losses"], losses)))
    state["left_out"] = sorted(set(gnorm) - set(counted))
    return {"loss_gap": (loss_gap, limits["loss_gap"]),
            "grad_gap": (leaf_gap(state["grads"], grads, counted), limits["grad_gap"]),
            "change_gap": (leaf_gap(change, change_ref, counted), limits["change_gap"])}
