"""Plain CIFAR ResNet (He et al., arXiv:1512.03385, with the CIFAR stem of
the NBDT repository's ``nbdt/models/resnet.py``): a 3x3 stem without a
max-pool, four stages of BasicBlocks at 64, 128, 256 and 512 channels
(strides 1, 2, 2, 2), a 1x1 conv + BatchNorm shortcut where the shape
changes, global average pool, a linear classifier. NCHW, f32.

Parameter names are the upstream ones (``conv1``, ``bn1``,
``layer{i}.{j}.conv1/bn1/conv2/bn2/shortcut.{0,1}``, ``linear``), so one
state dict loads into this module and into the program's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.shortcut = nn.Sequential()
        if stride != 1 or cin != cout:
            self.shortcut = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                          nn.BatchNorm2d(cout))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.shortcut(x))


class ResNetCifar(nn.Module):
    def __init__(self, blocks=(2, 2, 2, 2), widths=(64, 128, 256, 512), num_classes: int = 10):
        super().__init__()
        self.conv1 = nn.Conv2d(3, widths[0], 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(widths[0])
        cin = widths[0]
        for i, (n, width) in enumerate(zip(blocks, widths), start=1):
            layers = []
            for j in range(n):
                layers.append(BasicBlock(cin, width, (1 if i == 1 else 2) if j == 0 else 1))
                cin = width
            setattr(self, f"layer{i}", nn.Sequential(*layers))
        self.linear = nn.Linear(cin, num_classes)

    @classmethod
    def from_sizes(cls, sizes: dict) -> "ResNetCifar":
        """The model of a configuration's ``model`` sizes."""
        return cls(sizes["blocks"], sizes["widths"], sizes["num_classes"])

    @property
    def classifier(self) -> nn.Linear:
        return self.linear

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Pooled features ``[B, 512]`` of NCHW images."""
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        return out.mean(dim=(2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.features(x))
