"""Load a pretrained NBDT and run single-image inference with decisions.

Counterpart of ``examples/load_pretrained.py`` (the reference's Colab
notebook): a ``SoftNBDT`` over ``--arch`` on ``--dataset``'s induced
hierarchy, loaded from ``--checkpoint`` (a local reference ``.pth`` or the
JAX package's ``.msgpack``) or, without one, at a seeded random init; it
prints the prediction and the decision path below the root with each step's
confidence, ``(1 - entropy) * 100``.

    python -m nbdt_torch.examples.load_pretrained image.png --arch ResNet18 \\
        --dataset CIFAR10 [--checkpoint ckpt.pth] [--device cpu]

Offline, there is no download: pass ``--checkpoint`` with a local file, or
omit it for a smoke test of the decision machinery.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..assets import get_dataset_wnids
from ..data.transforms import CIFAR_MEAN, CIFAR_STD
from ..hierarchy.build import build_induced_graph
from ..hierarchy.generate import resolve_centers
from ..model import SoftNBDT, load_checkpoint
from ..models import init_model
from ..tree import Tree, dataset_to_dummy_classes
from ..utils import DATASET_TO_CLASSES, DATASET_TO_NUM_CLASSES, load_image_from_path


def build_nbdt(cls, module, dataset: str, arch: str, hierarchy=None, checkpoint=None, **kw):
    """``cls`` (an NBDT wrapper) over ``module``, loaded from ``checkpoint``
    when one is given. Where the hierarchy (``induced-{arch}`` by default)
    is an induced one that is not vendored, the tree is induced from the
    loaded classifier's rows, as the JAX package's NBDT does."""
    if not hierarchy and not kw.get("path_graph"):
        hierarchy = f"induced-{arch}"
    try:
        return cls(dataset=dataset, model=module, arch=arch, hierarchy=hierarchy,
                   pretrained=checkpoint is not None, checkpoint_path=checkpoint, **kw)
    except FileNotFoundError:
        if not (hierarchy or "").startswith("induced"):
            raise
    if checkpoint is not None:
        module.load_state_dict(load_checkpoint(checkpoint, arch=arch), strict=True)
    wnids = get_dataset_wnids(dataset)
    classes = DATASET_TO_CLASSES.get(dataset) or dataset_to_dummy_classes(dataset)
    tree = Tree.from_graph(build_induced_graph(wnids, resolve_centers(model=module)), wnids,
                           classes=classes, dataset=dataset)
    return cls(dataset=dataset, model=module, arch=arch, tree=tree, **kw)


def predict(model: SoftNBDT, image, dataset: str) -> list:
    """The two lines the example prints for a PIL image, resized to 32px
    and normalized with CIFAR's statistics."""
    x = np.asarray(image.convert("RGB").resize((32, 32)), dtype=np.float32)[None] / 255.0
    x = (x - CIFAR_MEAN) / CIFAR_STD
    outputs, decisions = model.forward_with_decisions(x)
    classes = DATASET_TO_CLASSES.get(dataset)
    pred = int(np.argmax(outputs[0].cpu().numpy()))
    return [f"Prediction: {classes[pred] if classes else f'class{pred}'}",
            "Decisions: " + ", ".join(f"{d['name']} (Confidence: {(1 - d['entropy']) * 100:.2f}%)"
                                      for d in decisions[0][1:])]


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("image", help="path or URL of the input image")
    parser.add_argument("--dataset", default="CIFAR10")
    parser.add_argument("--arch", default="ResNet18")
    parser.add_argument("--checkpoint", default=None,
                        help="local reference .pth (or the JAX package's .msgpack) to load")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    module = init_model(args.arch, DATASET_TO_NUM_CLASSES[args.dataset], (32, 32, 3),
                        device=args.device)
    model = build_nbdt(SoftNBDT, module, args.dataset, args.arch, checkpoint=args.checkpoint,
                       device=args.device)
    lines = predict(model, load_image_from_path(args.image), args.dataset)
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
