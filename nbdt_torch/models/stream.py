"""What the torchvision-topology backbones of the zoo share (MobileNetV2,
MNASNet, ShuffleNetV2, DenseNet, AlexNet, VGG, GoogLeNet, Inception v3,
SqueezeNet).

Their layers sit in torchvision's ``nn.Sequential``s, so the state dicts
carry torchvision's keys and a torchvision ``.pth`` loads strictly. The JAX
modules' dtype rules run through :func:`run_layer`: a conv or linear layer
takes its input cast to its weight's dtype (flax's ``dtype=``), a BatchNorm
normalizes in f32 and returns f32 (flax's ``BatchNorm(dtype=float32)``),
and every other layer (ReLU, pools) keeps its input's dtype. A backbone
built with ``dtype=bfloat16`` holds its convs' weights in bf16 and its
classifier in f32 (ShuffleNetV2's ``fc`` excepted, as in JAX).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def run_layer(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """One layer under the JAX modules' dtype rules."""
    if isinstance(m, (nn.Conv2d, nn.Linear)):
        return m(x.to(m.weight.dtype))
    if isinstance(m, nn.BatchNorm2d):
        return m(x.float())
    return m(x)


class Stream(nn.Sequential):
    """``nn.Sequential`` whose layers run by :func:`run_layer`."""

    def forward(self, x):
        for m in self:
            x = run_layer(m, x)
        return x


def cast_convs(module: nn.Module, dtype: torch.dtype) -> None:
    """Every conv's weight and bias to ``dtype``; BatchNorms and linear
    layers stay f32."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype)


class ZooNet(nn.Module):
    """Base of the zoo's backbones: ``config`` holds the constructor's
    arguments but ``dtype``, so that :meth:`clone` builds the same
    architecture with other knobs; the caller loads its weights."""

    config: dict
    dtype: torch.dtype

    def clone(self, dtype: Optional[torch.dtype] = None) -> "ZooNet":
        return type(self)(**self.config, dtype=self.dtype if dtype is None else dtype)
