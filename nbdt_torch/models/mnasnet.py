"""MNASNet as an NCHW ``nn.Module`` with torchvision's parameter names
(its ``_version=2`` layout).

Counterpart of ``nbdt_tpu/models/mnasnet.py``: an alpha-scaled stem (all
eight base depths scale, as torchvision's ``_get_depths`` does), six stacks
of inverted residuals with ReLU, a 1x1 head conv to 1280 channels, the f32
global mean and an f32 classifier. Keys: ``layers.{0..16}`` (convs at 0, 3,
6 and 14, BatchNorms after each, the stacks at 8-13 with
``layers.{i}.{r}.layers.{0..7}`` inside), ``classifier.1`` (``classifier.0``
is torchvision's dropout, which the JAX module has not: an identity).

Every BatchNorm has torchvision's momentum ``1 - 0.9997`` (flax's 0.9997),
not 0.1: it shows only once the module trains.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .stream import Stream, ZooNet, cast_convs, run_layer

__all__ = ("MNASNet", "mnasnet0_5", "mnasnet0_75", "mnasnet1_0", "mnasnet1_3", "get_depths")

BN_MOMENTUM = 1 - 0.9997
BASE_DEPTHS = (32, 16, 24, 40, 80, 96, 192, 320)
# (kernel, stride, expansion, repeats) of each stack: torchvision's
STACKS = ((3, 2, 3, 3), (5, 2, 3, 3), (5, 2, 6, 3), (3, 1, 6, 2), (5, 2, 6, 4), (3, 1, 6, 1))


def _round_to_multiple_of(val: float, divisor: int, round_up_bias: float = 0.9) -> int:
    new_val = max(divisor, int(val + divisor / 2) // divisor * divisor)
    return new_val if new_val >= round_up_bias * val else new_val + divisor


def get_depths(alpha: float):
    """torchvision's ``_get_depths``: all eight channels scale, the stem's
    too."""
    return [_round_to_multiple_of(d * alpha, 8) for d in BASE_DEPTHS]


def _conv_bn_relu(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
                  relu: bool = True) -> list:
    layers = [nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False),
              nn.BatchNorm2d(cout, momentum=BN_MOMENTUM)]
    return layers + ([nn.ReLU()] if relu else [])


class _InvertedResidual(nn.Module):
    """``layers``: 1x1 expand, BN, ReLU, k x k depthwise, BN, ReLU, 1x1
    project, BN; the residual where the stride is 1 and the widths equal."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, expand: int):
        super().__init__()
        mid = cin * expand
        self.apply_residual = stride == 1 and cin == cout
        self.layers = Stream(*_conv_bn_relu(cin, mid, 1),
                             *_conv_bn_relu(mid, mid, kernel, stride, groups=mid),
                             *_conv_bn_relu(mid, cout, 1, relu=False))

    def forward(self, x):
        out = self.layers(x)
        return out + x if self.apply_residual else out


class MNASNet(ZooNet):
    """Takes NCHW input; ``forward(x, features_only=True)`` returns the f32
    pooled features (1280 wide)."""

    def __init__(self, alpha: float = 1.0, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = {"alpha": alpha, "num_classes": num_classes}
        self.dtype = dtype
        d = get_depths(alpha)
        layers = (_conv_bn_relu(3, d[0], 3, 2) + _conv_bn_relu(d[0], d[0], 3, groups=d[0])
                  + _conv_bn_relu(d[0], d[1], 1, relu=False))
        for (k, s, e, n), cin, cout in zip(STACKS, d[1:], d[2:]):
            layers.append(Stream(_InvertedResidual(cin, cout, k, s, e),
                                 *[_InvertedResidual(cout, cout, k, 1, e) for _ in range(n - 1)]))
        layers += _conv_bn_relu(d[7], 1280, 1)
        self.layers = Stream(*layers)
        self.classifier = nn.Sequential(nn.Identity(), nn.Linear(1280, num_classes))
        cast_convs(self, dtype)

    def forward(self, x, features_only: bool = False):
        out = self.layers(x).mean(dim=(2, 3)).float()
        if features_only:
            return out
        return run_layer(self.classifier[1], out)


def mnasnet0_5(num_classes: int = 1000, dtype=torch.float32) -> MNASNet:
    return MNASNet(0.5, num_classes, dtype=dtype)


def mnasnet0_75(num_classes: int = 1000, dtype=torch.float32) -> MNASNet:
    return MNASNet(0.75, num_classes, dtype=dtype)


def mnasnet1_0(num_classes: int = 1000, dtype=torch.float32) -> MNASNet:
    return MNASNet(1.0, num_classes, dtype=dtype)


def mnasnet1_3(num_classes: int = 1000, dtype=torch.float32) -> MNASNet:
    return MNASNet(1.3, num_classes, dtype=dtype)
