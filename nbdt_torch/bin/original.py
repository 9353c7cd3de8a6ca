"""Baseline (non-NBDT) single-image classifier CLI (counterpart of
``nbdt_tpu/bin/original.py``, the reference's ``nbdt-original``).

    python -m nbdt_torch.bin.original IMAGE --checkpoint ckpt.pth|ckpt.msgpack \\
        [--arch wrn28_10_cifar10] [--dataset CIFAR10] [--device cpu]

The ``nbdt`` CLI's preprocessing and backbone, but only the flat
classifier's prediction: for comparing against the NBDT's decisions.
"""

from __future__ import annotations

import argparse


def load_backbone(arch: str, dataset: str, checkpoint: str):
    """``arch`` for ``dataset``'s classes, loaded strictly from a local
    ``.pth`` or ``.msgpack`` checkpoint."""
    from ..model import load_checkpoint
    from ..models import get_model
    from ..utils import DATASET_TO_NUM_CLASSES

    module = get_model(arch, DATASET_TO_NUM_CLASSES[dataset])
    module.load_state_dict(load_checkpoint(checkpoint, arch=arch), strict=True)
    return module


def prediction(module, x, dataset: str, device="cuda"):
    """The class name (or index, for a dataset without names) that the
    backbone's logits pick for the first image of the NHWC batch ``x``."""
    from ..models import make_eval_fn
    from ..utils import DATASET_TO_CLASSES

    pred = int(make_eval_fn(module, device)(x).argmax(1)[0])
    classes = DATASET_TO_CLASSES.get(dataset)
    return classes[pred] if classes else pred


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("image")
    parser.add_argument("--arch", default="wrn28_10_cifar10")
    parser.add_argument("--dataset", default="CIFAR10")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if not args.checkpoint:
        parser.error("--checkpoint required (offline baseline CLI)")

    from .nbdt import preprocess
    from ..utils import load_image_from_path

    module = load_backbone(args.arch, args.dataset, args.checkpoint)
    x = preprocess(load_image_from_path(args.image))
    print("Prediction:", prediction(module, x, args.dataset, args.device))


if __name__ == "__main__":
    main()
