"""Config-driven ImageNet NBDT training (the reference's ClassyVision job).

Counterpart of ``examples/imagenet/train.py``: one JSON config
(``examples/imagenet/configs/*.json``) names the model, the loss
(cross-entropy plus ``tree_supervision_weight`` times SoftTreeSupLoss on
the ``induced-efficientnet_b7b`` hierarchy), SGD with momentum and weight
decay, and the composite learning-rate schedule (a linear warmup, then a
multistep decay: :func:`build_lr_schedule`, optax's schedule step for step).
Each epoch ends with top-1 and top-5 on the test set and prints JAX's line.

One process trains on one device. Several processes (``--multihost``, one
card each) form a ``(dp, tp)`` mesh: every rank loads the global batch and
keeps its dp rows (``shard_batch``), BatchNorm takes the statistics of the
whole dp batch (``convert_batchnorm``) and DDP averages the gradients over
dp, as JAX's sharded ``jit`` does; ``--tp N`` splits a ResNet's classifier
over N ranks (``shard_params(..., tp_shard_classifier=True)``). As in JAX,
``--tp`` falls back to 1 when it does not divide the device count.

The example passes no transform, so the model sees float pixels in 0-255,
as the JAX example's loader yields them. ``--bf16`` runs the backbone under
bf16 autocast with f32 parameters, losses and tree products.

Synthetic data, on the card, or on the CPU with ``--device cpu``:

    python -m nbdt_torch.examples.train_imagenet \\
        --config examples/imagenet/configs/resnet18-nbdt.json --synthetic --epochs 1
    python -m nbdt_torch.examples.train_imagenet \\
        --config examples/imagenet/configs/resnet18-nbdt.json --synthetic --device cpu \\
        --epochs 1 --batch-size 8

Real data: ``imagenet-1000/{train,val}`` ImageFolders under the config's
``data_root`` (:class:`nbdt_torch.data.Imagenet1000`).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..assets import get_dataset_wnids
from ..data import DataLoader, PrefetchLoader, SyntheticDataset
from ..hierarchy.build import build_induced_graph
from ..hierarchy.generate import resolve_centers
from ..metrics import TopK
from ..models import init_model
from ..rules import to_device_tree
from ..trainer import make_train_step
from ..tree import Tree
from ..utils import resolve_device


def build_lr_schedule(opt_cfg: dict, steps_per_epoch: int, epochs: int) -> Callable[[int], float]:
    """The learning rate of optimizer step ``count`` (0-based; the first
    update uses count 0): optax's ``join_schedules`` of a
    ``linear_schedule(start, peak, warmup_steps)`` and a
    ``piecewise_constant_schedule`` whose boundaries are the milestone
    epochs' first steps less the warmup (``join_schedules`` counts the
    second schedule from 0 at its boundary). A decay takes effect at its
    boundary step: optax scales where ``count >= boundary``."""
    sched_cfg = opt_cfg.get("lr", {})
    warmup_frac = sched_cfg.get("warmup_frac", 0.0555)
    start = sched_cfg.get("start_value", 0.1)
    peak = sched_cfg.get("end_value", 0.4)
    values = sched_cfg.get("values", [peak, peak / 10, peak / 100, peak / 1000])
    milestones = sched_cfg.get("milestones", [30, 60, 80])

    total = max(1, epochs * steps_per_epoch)
    warmup_steps = max(1, int(total * warmup_frac))
    boundaries = [m * steps_per_epoch - warmup_steps for m in milestones]
    if any(b < 1 for b in boundaries):
        bad = [m for m, b in zip(milestones, boundaries) if b < 1]
        raise ValueError(
            f"LR milestones {bad} (epochs) fall inside the warmup phase "
            f"({warmup_steps} steps ~= "
            f"{warmup_steps / max(1, steps_per_epoch):.1f} epochs); move "
            "them past warmup or shrink warmup_frac.")
    # a dict, as optax's: milestones on one step keep the last one's scale
    scales = sorted({b: values[i + 1] / values[i] for i, b in enumerate(boundaries)}.items())

    def lr_at(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (start - peak) * frac + peak
        lr = values[0]
        for boundary, scale in scales:
            if count - warmup_steps >= boundary:
                lr *= scale
        return lr

    return lr_at


def build_tree(model: torch.nn.Module, hierarchy, num_classes: int) -> Tree:
    """The config's vendored Imagenet1000 hierarchy under ``class{i}``
    names; where it cannot be read, a tree induced from the model's
    classifier rows over the first ``num_classes`` Imagenet1000 wnids (the
    offline stand-in for ``induced-efficientnet_b7b``)."""
    classes = [f"class{i}" for i in range(num_classes)]
    try:
        return Tree("Imagenet1000", hierarchy=hierarchy, classes=classes)
    except Exception:
        wnids = get_dataset_wnids("Imagenet1000")[:num_classes]
        return Tree.from_graph(build_induced_graph(wnids, resolve_centers(model=model)), wnids,
                               classes=classes)


def build_datasets(cfg: dict, synthetic: bool, num_classes: int, image: int, batch: int):
    """(train, test): ``SyntheticDataset`` of 2 batches and of 1 (seed 1),
    or Imagenet1000 from the config's ``data_root``."""
    if synthetic:
        return (SyntheticDataset(num_classes, size=2 * batch, image_size=image),
                SyntheticDataset(num_classes, size=batch, image_size=image, seed=1))
    from ..data import Imagenet1000

    root = cfg.get("data_root", "./data")
    return Imagenet1000(root=root, train=True), Imagenet1000(root=root, train=False)


def main(argv=None) -> dict:
    """Trains as the config says; returns ``{"mesh": (dp, tp), "tree":
    Tree, "model": the live model, "lrs": the learning rate of every step,
    "step_losses": every step's loss, "epochs": per epoch the last step's
    loss, top-1, top-5 (in %) and seconds}``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--synthetic", action="store_true",
                        help="random data (offline smoke run)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override config num_epochs")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree for the classifier")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 conv compute (f32 params/losses)")
    parser.add_argument("--multihost", action="store_true",
                        help="join a multi-process mesh (coordinator/process info via flags or "
                             "NBDT_* / torchrun env vars)")
    parser.add_argument("--coordinator-address", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.multihost:
        from ..parallel import initialize_multihost

        initialize_multihost(args.coordinator_address, args.num_processes, args.process_id,
                             backend=None if device.type == "cuda" else "gloo")

    with open(args.config) as f:
        cfg = json.load(f)
    epochs = args.epochs or cfg.get("num_epochs", 90)
    model_cfg = cfg.get("model", {})
    arch = model_cfg.get("arch", "ResNet18")
    num_classes = model_cfg.get("num_classes", 1000)
    image = model_cfg.get("image_size", 224)
    batch = args.batch_size or cfg.get("batch_size", 256)
    loss_cfg = cfg.get("loss", {})
    tsw = loss_cfg.get("tree_supervision_weight", 5.0)
    opt_cfg = cfg.get("optimizer", {})

    # The mesh: every rank on dp (x tp). One process is a one-device mesh
    # and needs no process group.
    world = dist.get_world_size() if dist.is_initialized() else 1
    tp = args.tp if world % max(args.tp, 1) == 0 else 1
    mesh = None
    if dist.is_initialized():
        from ..parallel import make_mesh

        mesh = make_mesh(tp=tp, device=device)
    print(f"mesh: dp={world // tp} tp={tp}")

    model = init_model(arch, num_classes, (image, image, 3), device=device)
    tree = build_tree(model, loss_cfg.get("hierarchy"), num_classes)
    jt = to_device_tree(tree.arrays, device)

    trainset, testset = build_datasets(cfg, args.synthetic, num_classes, image, batch)
    trainloader = PrefetchLoader(DataLoader(trainset, batch_size=batch, shuffle=True))
    testloader = DataLoader(testset, batch_size=batch, pad_last=True, drop_last=False)
    lr_at = build_lr_schedule(opt_cfg, len(trainloader), epochs)

    forward, group = model, None
    if mesh is not None:
        from torch.nn.parallel import DistributedDataParallel

        from ..parallel import convert_batchnorm, shard_batch, shard_params

        group = mesh.get_group("dp")
        convert_batchnorm(model, group)
        shard_params(mesh, model, tp_shard_classifier=tp > 1)
        if world // tp > 1:
            ids = [torch.cuda.current_device()] if device.type == "cuda" else None
            forward = DistributedDataParallel(model, device_ids=ids, process_group=group,
                                              broadcast_buffers=False)
    # optax's add_decayed_weights -> trace(momentum) -> scale_by_learning_rate,
    # on every parameter (BatchNorm's and the biases too)
    optimizer = torch.optim.SGD(model.parameters(), lr=lr_at(0),
                                momentum=opt_cfg.get("momentum", 0.9),
                                weight_decay=opt_cfg.get("weight_decay", 1e-4))
    step = make_train_step(model, optimizer, lr_at, "SoftTreeSupLoss", jt, tsw=tsw,
                           bf16=args.bf16, forward=forward, group=group)

    def put(*arrays):
        if mesh is not None:
            return shard_batch(mesh, *arrays)
        return tuple(torch.as_tensor(np.asarray(a)).to(device) for a in arrays)

    out = {"mesh": (world // tp, tp), "tree": tree, "model": model, "lrs": [],
           "step_losses": [], "epochs": []}
    count = 0
    for epoch in range(epochs):
        t0 = time.time()
        losses = []
        for x, y, _ in trainloader:
            x, y = put(x, y)
            losses.append(step(x, y.long(), tsw, 1.0, count)["loss"])
            out["lrs"].append(optimizer.param_groups[0]["lr"])
            count += 1
        losses = [float(v) for v in losses]  # one sync an epoch
        out["step_losses"] += losses
        top1, top5 = TopK(1), TopK(5)
        model.eval()
        with torch.no_grad(), torch.autocast(device.type, torch.bfloat16, enabled=args.bf16):
            for x, y, valid in testloader:
                x = torch.as_tensor(x, device=device).permute(0, 3, 1, 2)
                logits = model(x).float().cpu().numpy()
                top1.forward(logits[valid], y[valid])
                top5.forward(logits[valid], y[valid])
        rec = {"loss": losses[-1] if losses else 0.0, "top1": top1.report() * 100,
               "top5": top5.report() * 100, "seconds": time.time() - t0}
        out["epochs"].append(rec)
        print(f"epoch {epoch}: loss={rec['loss']:.4f} top1={rec['top1']:.2f}% "
              f"top5={rec['top5']:.2f}% ({rec['seconds']:.1f}s)")
    return out


if __name__ == "__main__":
    main()
