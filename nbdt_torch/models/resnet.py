"""CIFAR-style ResNet backbones as NCHW ``nn.Module``s.

Counterpart of ``nbdt_tpu/models/resnet.py`` (BasicBlock family with the
CIFAR stem: 3x3 stem, no maxpool, 4 stages, global average pool, ``linear``
head). Parameter names are the reference torch ones (``conv1``, ``bn1``,
``layerS.I.conv1/bn1/...``, ``shortcut.0/.1``, ``linear``), so a state dict
exported from the JAX package loads with ``strict=True``.

``dtype`` mirrors the flax knob: with bf16 the convs hold bf16 weights and
compute in bf16, every BatchNorm normalizes in f32, and the pooled features
are cast to f32 before the f32 ``linear`` head. ``folded=True`` is the
serving variant with the BatchNorms baked into conv biases
(:func:`nbdt_torch.models.fold.fold_batchnorm`); there the activations stay in
``dtype`` end to end.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.to(conv.weight.dtype))


def _norm(bn: Optional[nn.BatchNorm2d], x: torch.Tensor) -> torch.Tensor:
    return x if bn is None else bn(x.float())


class BasicBlock(nn.Module):
    """conv3x3-bn-relu, conv3x3-bn, +shortcut, relu."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 folded: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=folded)
        self.bn1 = None if folded else nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=folded)
        self.bn2 = None if folded else nn.BatchNorm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != self.expansion * planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, self.expansion * planes, 1, stride, bias=folded),
                *([] if folded else [nn.BatchNorm2d(self.expansion * planes)]),
            )

    def forward(self, x):
        out = F.relu(_norm(self.bn1, _conv(self.conv1, x)))
        out = _norm(self.bn2, _conv(self.conv2, out))
        shortcut = x
        if len(self.shortcut):
            bn = self.shortcut[1] if len(self.shortcut) > 1 else None
            shortcut = _norm(bn, _conv(self.shortcut[0], x))
        return F.relu(out + shortcut)


class ResNet(nn.Module):
    """CIFAR ResNet: features + linear head. Takes NCHW input."""

    def __init__(self, block, num_blocks: Sequence[int], num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, folded: bool = False):
        super().__init__()
        self.block, self.num_blocks, self.num_classes = block, tuple(num_blocks), num_classes
        self.dtype, self.folded = dtype, folded
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=folded)
        self.bn1 = None if folded else nn.BatchNorm2d(64)
        in_planes = 64
        for stage, (planes, blocks, stride) in enumerate(
            zip((64, 128, 256, 512), self.num_blocks, (1, 2, 2, 2)), start=1
        ):
            layers = []
            for s in [stride] + [1] * (blocks - 1):
                layers.append(block(in_planes, planes, s, folded=folded))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*layers))
        self.linear = nn.Linear(512 * block.expansion, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)

    def forward(self, x, features_only: bool = False):
        out = F.relu(_norm(self.bn1, _conv(self.conv1, x)))
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        out = out.mean(dim=(2, 3)).float()  # global average pool
        if features_only:
            return out
        return self.linear(out)

    def clone(self, dtype: Optional[torch.dtype] = None,
              folded: Optional[bool] = None) -> "ResNet":
        """A fresh module of the same architecture with other knobs; the
        caller loads its weights."""
        return ResNet(
            self.block, self.num_blocks, self.num_classes,
            dtype=self.dtype if dtype is None else dtype,
            folded=self.folded if folded is None else folded,
        )


def ResNet10(num_classes: int = 10, dtype=torch.float32) -> ResNet:
    return ResNet(BasicBlock, (1, 1, 1, 1), num_classes, dtype=dtype)


def ResNet18(num_classes: int = 10, dtype=torch.float32) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, dtype=dtype)
