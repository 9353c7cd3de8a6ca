"""DenseNet-BC (121, 161, 169, 201) as NCHW ``nn.Module``s with torchvision's
parameter names.

Counterpart of ``nbdt_tpu/models/densenet.py``: a 7x7 stride-2 stem with a
max-pool, dense blocks of BN-ReLU-1x1-BN-ReLU-3x3 layers whose outputs are
concatenated onto their inputs, 1x1 + 2x2 average-pool transitions halving
the width, a final BatchNorm + ReLU, the f32 global mean and an f32
``classifier``. Keys: ``features.conv0``, ``features.norm0``,
``features.denseblock{b}.denselayer{l}.{norm1,conv1,norm2,conv2}``,
``features.transition{t}.{norm,conv}``, ``features.norm5``,
``classifier``. Pooled features: 1024, 2208, 1664 and 1920 wide.

With ``dtype=bfloat16`` the concatenation promotes as JAX's does: f32
BatchNorm outputs beside bf16 conv outputs give f32 (the first block), a
transition's bf16 pool output makes the next block's stream bf16.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .stream import Stream, ZooNet, cast_convs, run_layer

__all__ = ("DenseNet", "densenet121", "densenet161", "densenet169", "densenet201")

# depth -> (layers of each block, growth rate); the stem is 2 * growth wide
CONFIGS = {
    121: ((6, 12, 24, 16), 32),
    161: ((6, 12, 36, 24), 48),
    169: ((6, 12, 32, 32), 32),
    201: ((6, 12, 48, 32), 32),
}
BN_SIZE = 4


class _DenseLayer(nn.Module):
    def __init__(self, cin: int, growth: int):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(cin)
        self.conv1 = nn.Conv2d(cin, BN_SIZE * growth, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(BN_SIZE * growth)
        self.conv2 = nn.Conv2d(BN_SIZE * growth, growth, 3, 1, 1, bias=False)

    def forward(self, x):
        out = run_layer(self.conv1, F.relu(run_layer(self.norm1, x)))
        out = run_layer(self.conv2, F.relu(run_layer(self.norm2, out)))
        return torch.cat((x, out), dim=1)


class _DenseBlock(nn.Module):
    def __init__(self, layers: int, cin: int, growth: int):
        super().__init__()
        for i in range(layers):
            self.add_module(f"denselayer{i + 1}", _DenseLayer(cin + i * growth, growth))

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class DenseNet(ZooNet):
    """Takes NCHW input; ``forward(x, features_only=True)`` returns the f32
    pooled features."""

    def __init__(self, depth: int = 121, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = {"depth": depth, "num_classes": num_classes}
        self.dtype = dtype
        blocks, growth = CONFIGS[depth]
        c = 2 * growth
        layers = OrderedDict(conv0=nn.Conv2d(3, c, 7, 2, 3, bias=False), norm0=nn.BatchNorm2d(c),
                             relu0=nn.ReLU(), pool0=nn.MaxPool2d(3, 2, 1))
        for i, n in enumerate(blocks):
            layers[f"denseblock{i + 1}"] = _DenseBlock(n, c, growth)
            c += n * growth
            if i != len(blocks) - 1:
                layers[f"transition{i + 1}"] = Stream(OrderedDict(
                    norm=nn.BatchNorm2d(c), relu=nn.ReLU(),
                    conv=nn.Conv2d(c, c // 2, 1, bias=False), pool=nn.AvgPool2d(2, 2)))
                c //= 2
        layers["norm5"] = nn.BatchNorm2d(c)
        self.features = Stream(layers)
        self.classifier = nn.Linear(c, num_classes)
        cast_convs(self, dtype)

    def forward(self, x, features_only: bool = False):
        out = F.relu(self.features(x)).mean(dim=(2, 3)).float()
        if features_only:
            return out
        return self.classifier(out)


def densenet121(num_classes: int = 1000, dtype=torch.float32) -> DenseNet:
    return DenseNet(121, num_classes, dtype=dtype)


def densenet161(num_classes: int = 1000, dtype=torch.float32) -> DenseNet:
    return DenseNet(161, num_classes, dtype=dtype)


def densenet169(num_classes: int = 1000, dtype=torch.float32) -> DenseNet:
    return DenseNet(169, num_classes, dtype=dtype)


def densenet201(num_classes: int = 1000, dtype=torch.float32) -> DenseNet:
    return DenseNet(201, num_classes, dtype=dtype)
