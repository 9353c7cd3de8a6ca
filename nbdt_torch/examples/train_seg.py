"""Segmentation training with per-pixel tree supervision (the SegNBDT pipeline).

Counterpart of ``examples/segmentation/train_seg.py``: the small
encoder-decoder :class:`~nbdt_torch.models.segnet.SegNet` emits per-pixel
class maps; an induced tree is built from its 1x1 head's rows; each SGD step
(momentum 0.9) minimises the void-masked cross-entropy plus ``--tsw`` times
the per-pixel soft tree loss over the flattened NHWC pixels; each epoch ends
with the per-pixel accuracy on the valid pixels of the validation set; a
closing ``SoftSegNBDT`` forward runs the tree on one batch. The batches are
the JAX example's, draw for draw.

Offline, on synthetic masks (on the card; ``--device cpu`` on the CPU):

    python -m nbdt_torch.examples.train_seg --dataset synthetic --epochs 2
    python -m nbdt_torch.examples.train_seg --device cpu --epochs 1 --batch-size 2 --crop 32

Real data: ``--dataset LookIntoPerson|PascalContext|ADE20K --data-root ...``
(the layouts are in the docstrings of :mod:`nbdt_torch.data.segmentation`).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List

import torch

from ..assets import dataset_to_dummy_wnids
from ..data.segmentation import (ADE20K, LookIntoPerson, PascalContext, SegDataLoader,
                                 SyntheticSegDataset)
from ..hierarchy.build import build_induced_graph
from ..losses import masked_cross_entropy, soft_seg_tree_sup_loss
from ..model import SoftSegNBDT
from ..models.segnet import SegNet
from ..rules import DeviceTreeArrays, to_device_tree
from ..tree import Tree
from ..utils import resolve_device

DATASETS = {"PascalContext": PascalContext, "LookIntoPerson": LookIntoPerson, "ADE20K": ADE20K}


def build_datasets(dataset: str, data_root: str, batch_size: int, crop: int):
    """(train, val, num_classes, classes). ``synthetic``: 20 classes, 8
    batches of train images and 2 of val, each ``crop`` pixels square."""
    if dataset == "synthetic":
        train = SyntheticSegDataset(num_classes=20, size=8 * batch_size, image_size=crop)
        val = SyntheticSegDataset(num_classes=20, size=2 * batch_size, image_size=crop, seed=1)
        val.split = "val"
        return train, val, 20, train.classes
    cls = DATASETS[dataset]
    train = cls(root=data_root, split="train", crop_size=crop)
    val = cls(root=data_root, split="val", crop_size=crop)
    return train, val, cls.NUM_CLASS, cls.classes


def induce_tree(model: SegNet, classes) -> Tree:
    """The induced tree of the head's class rows, under the JAX example's
    wnids (LookIntoPerson's dummies up to 20 classes, else ``f########``)."""
    n = model.num_classes
    wnids = (dataset_to_dummy_wnids("LookIntoPerson")[:n] if n <= 20
             else [f"f{i:08d}" for i in range(n)])
    centers = model.head.weight.detach()[:, :, 0, 0].cpu().numpy()
    return Tree.from_graph(build_induced_graph(wnids, centers), wnids, classes=list(classes))


def seg_loss(out_nhwc: torch.Tensor, y: torch.Tensor, jt: DeviceTreeArrays,
             tsw: float) -> torch.Tensor:
    """Masked CE plus ``tsw`` times the soft tree loss, over every pixel."""
    flat, flat_y = out_nhwc.reshape(-1, out_nhwc.shape[-1]), y.reshape(-1)
    return masked_cross_entropy(flat, flat_y) + tsw * soft_seg_tree_sup_loss(flat, flat_y, jt)


def make_seg_step(model: SegNet, optimizer: torch.optim.Optimizer, jt: DeviceTreeArrays,
                  tsw: float) -> Callable:
    """``step(x [N, H, W, 3] f32, y [N, H, W] int)`` on the model's device:
    one SGD step in train mode (BatchNorm on the batch's statistics); returns
    the loss, on the device."""

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        model.train()
        loss = seg_loss(model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1), y, jt, tsw)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


@torch.no_grad()
def pixel_accuracy(model: SegNet, loader, device) -> tuple:
    """(correct, total) of the eval-mode argmax on the valid (>= 0) pixels."""
    model.eval()
    correct = total = 0
    for x, y in loader:
        pred = model(torch.as_tensor(x, device=device).permute(0, 3, 1, 2)).argmax(1)
        y = torch.as_tensor(y, device=device)
        valid = y >= 0
        correct += int((pred[valid] == y[valid]).sum())
        total += int(valid.sum())
    return correct, total


def fit(model: SegNet, jt: DeviceTreeArrays, loader, val_loader, epochs: int, lr: float,
        tsw: float, device, log: Callable = print) -> List[dict]:
    """SGD (momentum 0.9) over ``epochs`` epochs of ``loader``; per epoch the
    step losses, the last one, the pixel accuracy and the seconds."""
    step = make_seg_step(model, torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9),
                         jt, tsw)
    records = []
    for epoch in range(epochs):
        t0, losses = time.time(), []
        for x, y in loader:
            losses.append(step(torch.as_tensor(x, device=device),
                               torch.as_tensor(y, device=device)))
        losses = [float(v) for v in losses]  # one sync an epoch
        correct, total = pixel_accuracy(model, val_loader, device)
        rec = {"epoch": epoch, "loss": losses[-1] if losses else None, "step_losses": losses,
               "pixel_acc": 100 * correct / max(total, 1), "seconds": time.time() - t0}
        records.append(rec)
        loss = "n/a" if rec["loss"] is None else f"{rec['loss']:.4f}"
        log(f"epoch {epoch}: loss={loss} pixel_acc={rec['pixel_acc']:.2f}% "
            f"({rec['seconds']:.1f}s)")
    return records


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", default="synthetic", choices=["synthetic", *DATASETS])
    parser.add_argument("--data-root", default="./data")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--crop", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--tsw", type=float, default=1.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    train, val, num_classes, classes = build_datasets(args.dataset, args.data_root,
                                                      args.batch_size, args.crop)
    loader = SegDataLoader(train, args.batch_size, shuffle=True)
    val_loader = SegDataLoader(val, args.batch_size, drop_last=False)
    x0, _ = next(iter(loader))  # the JAX example's init batch: its draws come first
    torch.manual_seed(0)
    # channels-last until the trainer places the model itself (models/layout.py)
    model = SegNet(num_classes).to(device, memory_format=torch.channels_last)
    tree = induce_tree(model, classes)
    records = fit(model, to_device_tree(tree.arrays, device), loader, val_loader, args.epochs,
                  args.lr, args.tsw, device)

    # SegNBDT per-pixel tree inference over one batch
    out = SoftSegNBDT(dataset=None, model=model, tree=tree, device=device)(x0)
    print("SoftSegNBDT output:", tuple(out.shape))
    return {"epochs": records, "num_classes": num_classes, "output_shape": tuple(out.shape)}


if __name__ == "__main__":
    main()
