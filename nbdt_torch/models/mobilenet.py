"""MobileNetV2 as an NCHW ``nn.Module`` with torchvision's parameter names.

Counterpart of ``nbdt_tpu/models/mobilenet.py``: inverted residuals with
linear projections, ReLU6 after the BatchNorms (eps 1e-5, f32), a 1x1 head
conv to 1280 channels, the global mean in f32 and an f32 classifier. Keys:
``features.0.{0,1}`` the stem, ``features.{1..17}.conv.*`` the blocks (the
first, expand ratio 1, is ``[dw, dw bn, project, project bn]``; the others
put ``[expand, expand bn]`` first), ``features.18.{0,1}`` the head conv,
``classifier.1`` the classifier (``classifier.0`` is torchvision's dropout,
which the JAX module has not: here an identity).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .stream import Stream, ZooNet, cast_convs, run_layer

__all__ = ("MobileNetV2", "mobilenet_v2")

# (expansion t, out channels c, repeats n, stride s): torchvision's defaults
INVERTED_RESIDUAL_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _conv_bn_relu6(cin: int, cout: int, kernel: int, stride: int = 1,
                   groups: int = 1) -> Stream:
    """A bias-free conv (key ``0``), its BatchNorm (``1``) and ReLU6:
    torchvision's ``Conv2dNormActivation`` layout."""
    return Stream(nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups,
                            bias=False), nn.BatchNorm2d(cout), nn.ReLU6())


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    """``conv``: [1x1 expand + BN + ReLU6,] 3x3 depthwise + BN + ReLU6, 1x1
    project + BN; the residual where the stride is 1 and the widths equal."""

    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = cin * expand_ratio
        self.use_res = stride == 1 and cin == cout
        layers = [_conv_bn_relu6(cin, hidden, 1)] if expand_ratio != 1 else []
        layers += [_conv_bn_relu6(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False), nn.BatchNorm2d(cout)]
        self.conv = Stream(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(ZooNet):
    """Takes NCHW input; ``forward(x, features_only=True)`` returns the f32
    pooled features (1280 wide at ``width_mult`` 1)."""

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = {"num_classes": num_classes, "width_mult": width_mult}
        self.dtype = dtype
        cin = _make_divisible(32 * width_mult)
        layers = [_conv_bn_relu6(3, cin, 3, 2)]
        for t, c, n, s in INVERTED_RESIDUAL_SETTINGS:
            cout = _make_divisible(c * width_mult)
            for i in range(n):
                layers.append(InvertedResidual(cin, cout, s if i == 0 else 1, t))
                cin = cout
        last = _make_divisible(1280 * max(1.0, width_mult))
        layers.append(_conv_bn_relu6(cin, last, 1))
        self.features = Stream(*layers)
        self.classifier = nn.Sequential(nn.Identity(), nn.Linear(last, num_classes))
        cast_convs(self, dtype)

    def forward(self, x, features_only: bool = False):
        out = self.features(x).mean(dim=(2, 3)).float()
        if features_only:
            return out
        return run_layer(self.classifier[1], out)


def mobilenet_v2(num_classes: int = 1000, dtype=torch.float32) -> MobileNetV2:
    return MobileNetV2(num_classes, dtype=dtype)
