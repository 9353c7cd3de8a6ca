"""Dataset registries, asset paths, device resolution and tensor coercion.

Counterpart of ``nbdt_tpu/utils.py``, kept to what the soft-NBDT inference
path needs. The hierarchy JSONs and wnid lists are the JAX package's vendored
data files: they are read from ``nbdt_tpu/`` by filesystem path, resolved
from this file's own location, so nothing of that package is imported.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

DATASET_TO_NUM_CLASSES = {
    "CIFAR10": 10,
    "CIFAR100": 100,
    "TinyImagenet200": 200,
    "Imagenet1000": 1000,
    "Cityscapes": 19,
    "PascalContext": 59,
    "LookIntoPerson": 20,
    "ADE20K": 150,
}

DATASET_TO_CLASSES = {
    "CIFAR10": [
        "airplane",
        "automobile",
        "bird",
        "cat",
        "deer",
        "dog",
        "frog",
        "horse",
        "ship",
        "truck",
    ],
}

# The vendored data files live beside the JAX package: hierarchies/ and wnids/.
ASSETS_ROOT = Path(__file__).resolve().parent.parent / "nbdt_tpu"


def hierarchy_to_path_graph(dataset: str, hierarchy: str) -> str:
    return os.path.join(ASSETS_ROOT, f"hierarchies/{dataset}/graph-{hierarchy}.json")


def dataset_to_default_path_graph(dataset: str) -> str:
    return hierarchy_to_path_graph(dataset, "induced")


def dataset_to_default_path_wnids(dataset: str) -> str:
    return os.path.join(ASSETS_ROOT, f"wnids/{dataset}.txt")


def makeparentdirs(path) -> None:
    os.makedirs(Path(path).parent, exist_ok=True)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere in
    this package; asking for it where there is no card raises rather than
    running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def coerce_tensor(x, is_label: bool = False):
    """[N, H, W, C] -> [N*H*W, C] (labels [N, H, W] -> [N*H*W, 1])."""
    if is_label:
        return x.reshape(-1, 1)
    return x.reshape(-1, x.shape[-1])


def uncoerce_tensor(x, original_shape):
    """[N*H*W, C] -> [N, H, W, C]."""
    n, h, w, c = original_shape
    return x.reshape(n, h, w, c)
