"""Backbones of the port: the CIFAR ResNets, the WideResNets, the ViTs, BN
folding, the converter and the registry."""

from typing import Callable, Dict, Optional

import torch

from .convert import pytorchcv_wrn_keys, state_dict_from_flax
from .fold import fold_batchnorm
from .resnet import BasicBlock, ResNet, ResNet10, ResNet18
from .vit import ViT, vit_b16, vit_s16
from .wideresnet import WRN, wrn28_10, wrn28_10_cifar10, wrn28_10_cifar100

MODEL_REGISTRY: Dict[str, Callable] = {
    "ResNet10": ResNet10,
    "ResNet18": ResNet18,
    "vit_b16": vit_b16,
    "vit_s16": vit_s16,
    "wrn28_10": wrn28_10,
    "wrn28_10_cifar10": wrn28_10_cifar10,
    "wrn28_10_cifar100": wrn28_10_cifar100,
    "WRN": WRN,
}


# Backbones built for one input resolution (their position embeddings); the
# convolutional ones take any.
FIXED_RESOLUTION = ("vit_b16", "vit_s16")


def get_model(arch: str, num_classes: int, dtype: torch.dtype = torch.float32,
              image_size: Optional[int] = None, **kw):
    """A backbone of the port by name (``MODEL_REGISTRY``); ``image_size``
    builds the ViTs for that input resolution (the others ignore it), and
    ``kw`` go to its constructor (``ln_impl``, ``attention_impl`` for a
    ViT)."""
    if arch not in MODEL_REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; the port has {sorted(MODEL_REGISTRY)}")
    if image_size is not None and arch in FIXED_RESOLUTION:
        kw["image_size"] = image_size
    return MODEL_REGISTRY[arch](num_classes=num_classes, dtype=dtype, **kw)
