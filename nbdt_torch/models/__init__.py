"""Backbones of the port: the CIFAR ResNets, the ViTs, BN folding, the
converter and the registry."""

from typing import Callable, Dict

import torch

from .convert import state_dict_from_flax
from .fold import fold_batchnorm
from .resnet import BasicBlock, ResNet, ResNet10, ResNet18
from .vit import ViT, vit_b16, vit_s16

MODEL_REGISTRY: Dict[str, Callable] = {
    "ResNet10": ResNet10,
    "ResNet18": ResNet18,
    "vit_b16": vit_b16,
    "vit_s16": vit_s16,
}


def get_model(arch: str, num_classes: int, dtype: torch.dtype = torch.float32, **kw):
    """A backbone of the port by name (``MODEL_REGISTRY``); ``kw`` go to its
    constructor (``ln_impl``, ``attention_impl``, ``image_size`` for a ViT)."""
    if arch not in MODEL_REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; the port has {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[arch](num_classes=num_classes, dtype=dtype, **kw)
