"""Single-image NBDT inference CLI (counterpart of ``nbdt_tpu/bin/nbdt.py``,
the reference's ``nbdt`` command).

    python -m nbdt_torch.bin.nbdt IMAGE_PATH_OR_URL [--arch wrn28_10_cifar10] \\
        [--dataset CIFAR10] [--checkpoint ckpt.pth|ckpt.msgpack] \\
        [--hierarchy wordnet] [--hard] [--device cpu]

Prints the prediction plus each decision on its path with its confidence,
``(1 - entropy) * 100``, as the reference does: it is negative at a node
with more than two children. Without ``--checkpoint`` the released
checkpoint of ``(arch, dataset[, hierarchy])`` is read from the local cache
(``$NBDT_CHECKPOINT_DIR``) and fetched only when it is not there. Decoding
the image needs PIL.
"""

from __future__ import annotations

import argparse

import numpy as np


def preprocess(image, size: int = 32, mean=None, std=None) -> np.ndarray:
    """Resize (the short side to ``size``), centre crop, normalize: a PIL
    image as an NHWC f32 batch of one, as the JAX CLI makes it."""
    from ..data.transforms import CIFAR_MEAN, CIFAR_STD

    mean = mean if mean is not None else CIFAR_MEAN
    std = std if std is not None else CIFAR_STD
    w, h = image.size
    scale = size / min(w, h)
    image = image.resize((max(size, int(round(w * scale))),
                          max(size, int(round(h * scale)))))
    w, h = image.size
    left, top = (w - size) // 2, (h - size) // 2
    image = image.crop((left, top, left + size, top + size))
    x = np.asarray(image.convert("RGB"), dtype=np.float32) / 255.0
    x = (x - mean) / std
    return x[None]


def build_model(arch: str, dataset: str, hierarchy=None, path_graph=None, path_wnids=None,
                checkpoint=None, hard: bool = False, random_init: bool = False, device="cuda",
                image_size: int = 32):
    """The CLI's NBDT: ``arch`` at a seeded random init, or loaded from
    ``checkpoint`` (``.pth`` or ``.msgpack``), or from the released
    checkpoint in the local cache when neither is given. ``image_size``
    sizes a ViT (the other backbones take any size)."""
    from ..model import HardNBDT, SoftNBDT
    from ..models import get_model, init_model
    from ..utils import DATASET_TO_NUM_CLASSES

    num_classes = DATASET_TO_NUM_CLASSES[dataset]
    if random_init:
        shape = (image_size, image_size, 3)
        module, kw = init_model(arch, num_classes, shape, seed=0, device=device), {}
    else:
        module = get_model(arch, num_classes, image_size=image_size)
        kw = {"pretrained": True, "checkpoint_path": checkpoint}
    cls = HardNBDT if hard else SoftNBDT
    return cls(dataset=dataset, model=module, arch=arch, hierarchy=hierarchy,
               path_graph=path_graph, path_wnids=path_wnids, device=device, **kw)


def decision_line(model, x) -> str:
    """The line the CLI prints for the first image of the NHWC batch
    ``x``: the predicted class, then each decision with its confidence."""
    outputs, decisions = model.forward_with_decisions(x)
    pred = int(outputs.argmax(1)[0])
    steps = ", ".join("{} (Confidence: {:.2f}%)".format(info["name"], (1 - info["entropy"]) * 100)
                      for info in decisions[0])
    return f"Prediction: {model.tree.classes[pred]} // Decisions: {steps}"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("image", help="path or URL of image to classify")
    parser.add_argument("--arch", default="wrn28_10_cifar10")
    parser.add_argument("--dataset", default="CIFAR10")
    parser.add_argument("--hierarchy", default=None)
    parser.add_argument("--path-graph", default=None)
    parser.add_argument("--path-wnids", default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="local .pth/.msgpack checkpoint (offline use)")
    parser.add_argument("--hard", action="store_true", help="use hard rules")
    parser.add_argument("--random-init", action="store_true",
                        help="skip the pretrained checkpoint and run a randomly initialized "
                             "backbone (offline demo of the decision-path machinery)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if args.random_init and args.checkpoint:
        parser.error("--random-init and --checkpoint are mutually exclusive")

    from ..utils import load_image_from_path

    model = build_model(args.arch, args.dataset, args.hierarchy, args.path_graph,
                        args.path_wnids, args.checkpoint, args.hard, args.random_init,
                        args.device)
    print(decision_line(model, preprocess(load_image_from_path(args.image))))


if __name__ == "__main__":
    main()
