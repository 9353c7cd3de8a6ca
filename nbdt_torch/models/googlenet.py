"""GoogLeNet (Inception v1) as an NCHW ``nn.Module`` with torchvision's
parameter names.

Counterpart of ``nbdt_tpu/models/googlenet.py``: ``BasicConv2d`` (a
bias-free conv, BatchNorm with eps 1e-3, ReLU), torchvision's ceil-mode
max-pools, nine Inception blocks (torchvision's 3x3 conv in ``branch3``
despite its ``ch5x5`` name), the f32 global mean and an f32 ``fc``. Keys:
``conv{1,2,3}.{conv,bn}``, ``inception{3a..5b}.branch1.{conv,bn}``,
``...branch{2,3}.{0,1}.{conv,bn}``, ``...branch4.1.{conv,bn}``, ``fc``.
The train-only auxiliary heads ``aux1``/``aux2`` are not built, as in JAX:
:func:`nbdt_torch.model.load_checkpoint` drops their keys.

``transform_input`` (default False, as torchvision's constructor) maps an
input normalized with ImageNet's mean and std to one normalized with mean
= std = 0.5, per channel. torchvision's pretrained loaders force it True,
so a released checkpoint reproduces its logits only with it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .stream import Stream, ZooNet, cast_convs, run_layer

__all__ = ("GoogLeNet", "googlenet", "BasicConv2d", "transform_input_rescale")

# (ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj) of each block, and the
# ceil-mode max-pool (kernel, stride) after 3b and 4e
BLOCKS = {
    "inception3a": (64, 96, 128, 16, 32, 32),
    "inception3b": (128, 128, 192, 32, 96, 64),
    "maxpool3": (3, 2),
    "inception4a": (192, 96, 208, 16, 48, 64),
    "inception4b": (160, 112, 224, 24, 64, 64),
    "inception4c": (128, 128, 256, 24, 64, 64),
    "inception4d": (112, 144, 288, 32, 64, 64),
    "inception4e": (256, 160, 320, 32, 128, 128),
    "maxpool4": (2, 2),
    "inception5a": (256, 160, 320, 32, 128, 128),
    "inception5b": (384, 192, 384, 48, 128, 128),
}


def transform_input_rescale(x: torch.Tensor) -> torch.Tensor:
    """torchvision's ``_transform_input`` on NCHW: channel c becomes
    ``x_c * (std_c / 0.5) + (mean_c - 0.5) / 0.5``."""
    scale = torch.tensor([0.229 / 0.5, 0.224 / 0.5, 0.225 / 0.5], dtype=x.dtype, device=x.device)
    shift = torch.tensor([(0.485 - 0.5) / 0.5, (0.456 - 0.5) / 0.5, (0.406 - 0.5) / 0.5],
                         dtype=x.dtype, device=x.device)
    return x * scale.view(1, 3, 1, 1) + shift.view(1, 3, 1, 1)


class BasicConv2d(nn.Module):
    """torchvision's: a bias-free conv, BatchNorm (eps 1e-3, f32), ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return torch.relu(run_layer(self.bn, run_layer(self.conv, x)))


class Inception(nn.Module):
    def __init__(self, cin: int, ch1x1: int, ch3x3red: int, ch3x3: int, ch5x5red: int,
                 ch5x5: int, pool_proj: int):
        super().__init__()
        self.branch1 = BasicConv2d(cin, ch1x1, 1)
        self.branch2 = Stream(BasicConv2d(cin, ch3x3red, 1), BasicConv2d(ch3x3red, ch3x3, 3,
                                                                         padding=1))
        self.branch3 = Stream(BasicConv2d(cin, ch5x5red, 1), BasicConv2d(ch5x5red, ch5x5, 3,
                                                                         padding=1))
        self.branch4 = Stream(nn.MaxPool2d(3, 1, 1, ceil_mode=True),
                              BasicConv2d(cin, pool_proj, 1))
        self.width = ch1x1 + ch3x3 + ch5x5 + pool_proj

    def forward(self, x):
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x), self.branch4(x)],
                         dim=1)


class GoogLeNet(ZooNet):
    """Takes NCHW input; ``forward(x, features_only=True)`` returns the f32
    pooled features (1024 wide)."""

    def __init__(self, num_classes: int = 1000, transform_input: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = {"num_classes": num_classes, "transform_input": transform_input}
        self.dtype, self.transform_input = dtype, transform_input
        self.conv1 = BasicConv2d(3, 64, 7, 2, 3)
        self.maxpool1 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2 = BasicConv2d(64, 64, 1)
        self.conv3 = BasicConv2d(64, 192, 3, padding=1)
        self.maxpool2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        c = 192
        for name, spec in BLOCKS.items():
            if name.startswith("maxpool"):
                setattr(self, name, nn.MaxPool2d(*spec, ceil_mode=True))
            else:
                setattr(self, name, Inception(c, *spec))
                c = getattr(self, name).width
        self.fc = nn.Linear(c, num_classes)
        cast_convs(self, dtype)

    def forward(self, x, features_only: bool = False):
        if self.transform_input:
            x = transform_input_rescale(x)
        x = self.maxpool1(self.conv1(x))
        x = self.maxpool2(self.conv3(self.conv2(x)))
        for name in BLOCKS:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3)).float()
        if features_only:
            return x
        return self.fc(x)


def googlenet(num_classes: int = 1000, dtype=torch.float32,
              transform_input: bool = False) -> GoogLeNet:
    return GoogLeNet(num_classes, transform_input, dtype=dtype)
