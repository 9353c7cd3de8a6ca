"""Inception v3 as an NCHW ``nn.Module`` with torchvision's parameter names.

Counterpart of ``nbdt_tpu/models/inception.py``: googlenet's
``BasicConv2d`` (BatchNorm eps 1e-3) throughout, the stem, blocks A-E
(``Mixed_5b`` ... ``Mixed_7c``, with the 1x7/7x1 convs), the f32 global
mean and an f32 ``fc``, 2048 wide. The train-only ``AuxLogits`` head is not
built, as in JAX (:func:`nbdt_torch.model.load_checkpoint` drops its keys),
and ``transform_input`` is googlenet's. The stem needs at least 75px.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .googlenet import BasicConv2d, transform_input_rescale
from .stream import ZooNet, cast_convs

__all__ = ("InceptionV3", "inception_v3")


def _pool(x):
    return F.avg_pool2d(x, 3, 1, 1)


def _chain(x, *convs):
    for conv in convs:
        x = conv(x)
    return x


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            _chain(x, self.branch5x5_1, self.branch5x5_2),
            _chain(x, self.branch3x3dbl_1, self.branch3x3dbl_2, self.branch3x3dbl_3),
            self.branch_pool(_pool(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            _chain(x, self.branch3x3dbl_1, self.branch3x3dbl_2, self.branch3x3dbl_3),
            F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            _chain(x, self.branch7x7_1, self.branch7x7_2, self.branch7x7_3),
            _chain(x, self.branch7x7dbl_1, self.branch7x7dbl_2, self.branch7x7dbl_3,
                   self.branch7x7dbl_4, self.branch7x7dbl_5),
            self.branch_pool(_pool(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        return torch.cat([
            _chain(x, self.branch3x3_1, self.branch3x3_2),
            _chain(x, self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                   self.branch7x7x3_4),
            F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = _chain(x, self.branch3x3dbl_1, self.branch3x3dbl_2)
        return torch.cat([
            self.branch1x1(x),
            self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
            self.branch_pool(_pool(x))], dim=1)


class InceptionV3(ZooNet):
    """Takes NCHW input; ``forward(x, features_only=True)`` returns the f32
    pooled features (2048 wide)."""

    def __init__(self, num_classes: int = 1000, transform_input: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = {"num_classes": num_classes, "transform_input": transform_input}
        self.dtype, self.transform_input = dtype, transform_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)
        cast_convs(self, dtype)

    def forward(self, x, features_only: bool = False):
        if self.transform_input:
            x = transform_input_rescale(x)
        x = _chain(x, self.Conv2d_1a_3x3, self.Conv2d_2a_3x3, self.Conv2d_2b_3x3)
        x = _chain(F.max_pool2d(x, 3, 2), self.Conv2d_3b_1x1, self.Conv2d_4a_3x3)
        x = _chain(F.max_pool2d(x, 3, 2), self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                   self.Mixed_6a, self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                   self.Mixed_7a, self.Mixed_7b, self.Mixed_7c)
        x = x.mean(dim=(2, 3)).float()
        if features_only:
            return x
        return self.fc(x)


def inception_v3(num_classes: int = 1000, dtype=torch.float32,
                 transform_input: bool = False) -> InceptionV3:
    return InceptionV3(num_classes, transform_input, dtype=dtype)
