"""The canonical serving forward (counterpart of ``make_serving_fn`` in
``nbdt_tpu/serving.py``)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from .data.transforms import CIFAR_MEAN, CIFAR_STD
from .models.fold import fold_batchnorm
from .rules import soft_forward, to_device_tree
from .utils import resolve_device


def make_serving_fn(
    module: nn.Module,
    tree,
    bf16: bool = True,
    fold_bn: bool = False,
    uint8_input: bool = False,
    normalize=None,
    device="cuda",
) -> Callable:
    """Build ``x [B,H,W,3] -> leaf probability distribution [B, C]``, the raw
    product of path probabilities (unnormalized; argmax is the prediction).

    ``module`` is a port backbone (a CIFAR or torchvision ResNet, ResNeXt or
    wide ResNet, a WRN, an EfficientNet, a ViT, or one of MobileNetV2,
    MNASNet, ShuffleNetV2, DenseNet, AlexNet, VGG, GoogLeNet, Inception v3
    and SqueezeNet) with ``dtype`` and ``clone(dtype=...)``. ``bf16`` runs
    it with a bfloat16 stream; node decisions always compute in f32.
    ``fold_bn`` folds BatchNorm into the conv weights first (the ResNet
    family; anything else, the EfficientNets and the rest of the zoo
    included, raises TypeError, as in the JAX package). ``uint8_input``
    accepts raw uint8 NHWC batches and normalizes on the device; ``normalize`` is ``(mean, std)`` in [0,1]
    units, the CIFAR constants by default. As in the JAX package this calls
    the plain rules (``soft_forward``), not the fused head.
    """
    device = resolve_device(device)
    jt = to_device_tree(tree.arrays, device)

    serving_module = module
    if fold_bn:
        serving_module = fold_batchnorm(serving_module)
    if bf16:
        source = serving_module
        serving_module = source.clone(dtype=torch.bfloat16)
        serving_module.load_state_dict(source.state_dict())
    serving_module = serving_module.to(device, memory_format=torch.channels_last).eval()

    if uint8_input:
        if normalize is None:
            normalize = (CIFAR_MEAN, CIFAR_STD)
        mean = torch.as_tensor(np.asarray(normalize[0], np.float32) * 255.0, device=device)
        # (x/255 - m)/s == (x - m*255) * inv, with inv = 1/(s*255)
        inv = torch.as_tensor(1.0 / (np.asarray(normalize[1], np.float32) * 255.0),
                              device=device)

    @torch.no_grad()
    def fn(x):
        x = torch.as_tensor(x, device=device)
        if uint8_input:
            # f32 affine, THEN the bf16 cast: the same rounding as the host
            # normalize + cast path
            x = (x.float() - mean) * inv
        if bf16:
            x = x.to(torch.bfloat16)
        logits = serving_module(x.permute(0, 3, 1, 2))
        return soft_forward(logits.float(), jt)

    return fn
