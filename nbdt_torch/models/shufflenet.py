"""ShuffleNetV2 as an NCHW ``nn.Module`` with torchvision's parameter names.

Counterpart of ``nbdt_tpu/models/shufflenet.py``: channel-split units with
3x3 depthwise convs and torchvision's channel shuffle after each unit, a
1x1 ``conv5``, the global mean and ``fc``. Keys: ``conv1.{0,1}``,
``stage{2,3,4}.{u}.branch{1,2}.{i}`` (torchvision's Sequential indices;
``branch1`` only in a unit of stride 2), ``conv5.{0,1}``, ``fc``.

As in JAX, ``fc`` runs in the stream's ``dtype`` (with bf16 its weight is
bf16 and the logits are bf16), and the pooled features are not cast before
it: they are f32 because ``conv5``'s BatchNorm returns f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .stream import Stream, ZooNet, cast_convs, run_layer

__all__ = ("ShuffleNetV2", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "channel_shuffle")

# stages_out_channels of each width; stages_repeats (4, 8, 4)
CHANNELS = {
    "x0_5": (24, 48, 96, 192, 1024),
    "x1_0": (24, 116, 232, 464, 1024),
    "x1_5": (24, 176, 352, 704, 1024),
    "x2_0": (24, 244, 488, 976, 2048),
}
REPEATS = (4, 8, 4)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """torchvision's: view the channels as ``(groups, C / groups)``,
    transpose, flatten."""
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


def _dw(c: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(c, c, 3, stride, 1, groups=c, bias=False)


class InvertedResidual(nn.Module):
    """Stride 1: split the channels in half, ``branch2`` on the second half.
    Stride 2: ``branch1`` (dw 3x3 + BN, 1x1 + BN + ReLU) and ``branch2`` (1x1
    + BN + ReLU, dw 3x3 + BN, 1x1 + BN + ReLU) on the whole input. Then
    concatenate and shuffle."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        c = cout // 2
        if stride > 1:
            self.branch1 = Stream(_dw(cin, stride), nn.BatchNorm2d(cin),
                                  nn.Conv2d(cin, c, 1, bias=False), nn.BatchNorm2d(c), nn.ReLU())
        else:
            self.branch1 = Stream()
        self.branch2 = Stream(nn.Conv2d(cin if stride > 1 else c, c, 1, bias=False),
                              nn.BatchNorm2d(c), nn.ReLU(), _dw(c, stride), nn.BatchNorm2d(c),
                              nn.Conv2d(c, c, 1, bias=False), nn.BatchNorm2d(c), nn.ReLU())

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat((x1, self.branch2(x2)), dim=1)
        else:
            out = torch.cat((self.branch1(x), self.branch2(x)), dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(ZooNet):
    """Takes NCHW input; ``forward(x, features_only=True)`` returns the f32
    pooled features (1024 wide, 2048 for x2_0)."""

    def __init__(self, width: str = "x1_0", num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = {"width": width, "num_classes": num_classes}
        self.dtype = dtype
        chans = CHANNELS[width]
        self.conv1 = Stream(nn.Conv2d(3, chans[0], 3, 2, 1, bias=False),
                            nn.BatchNorm2d(chans[0]), nn.ReLU())
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = chans[0]
        for i, (n, cout) in enumerate(zip(REPEATS, chans[1:4]), start=2):
            setattr(self, f"stage{i}", Stream(InvertedResidual(cin, cout, 2),
                                              *[InvertedResidual(cout, cout, 1)
                                                for _ in range(n - 1)]))
            cin = cout
        self.conv5 = Stream(nn.Conv2d(cin, chans[4], 1, bias=False), nn.BatchNorm2d(chans[4]),
                            nn.ReLU())
        self.fc = nn.Linear(chans[4], num_classes)
        cast_convs(self, dtype)
        self.fc.to(dtype)

    def forward(self, x, features_only: bool = False):
        x = self.maxpool(self.conv1(x))
        x = self.conv5(self.stage4(self.stage3(self.stage2(x))))
        x = x.mean(dim=(2, 3))
        if features_only:
            return x
        return run_layer(self.fc, x)


def shufflenet_v2_x0_5(num_classes: int = 1000, dtype=torch.float32) -> ShuffleNetV2:
    return ShuffleNetV2("x0_5", num_classes, dtype=dtype)


def shufflenet_v2_x1_0(num_classes: int = 1000, dtype=torch.float32) -> ShuffleNetV2:
    return ShuffleNetV2("x1_0", num_classes, dtype=dtype)


def shufflenet_v2_x1_5(num_classes: int = 1000, dtype=torch.float32) -> ShuffleNetV2:
    return ShuffleNetV2("x1_5", num_classes, dtype=dtype)


def shufflenet_v2_x2_0(num_classes: int = 1000, dtype=torch.float32) -> ShuffleNetV2:
    return ShuffleNetV2("x2_0", num_classes, dtype=dtype)
