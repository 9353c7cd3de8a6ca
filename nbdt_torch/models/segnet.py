"""SegNet: the seg trainer's small encoder-decoder (NCHW).

Counterpart of the flax ``SegNet`` of ``examples/segmentation/train_seg.py``:
conv 3->32, conv 32->64 at stride 2, conv 64->64 (3x3, each with a bias,
then BatchNorm at flax's momentum 0.9, i.e. torch's 0.1, then ReLU), a
nearest upsample back to the input's size, and a 1x1 head to per-pixel
class logits. Two details keep it equal to flax at every size:

- the stride-2 conv pads as flax's "SAME": ``ceil(n / 2)`` outputs, the
  pad split with its smaller half first, so an even side gets 0 rows before
  and 1 after where ``padding=1`` would shift every tap by one;
- the upsample is ``"nearest-exact"`` (half-pixel centres, as
  ``jax.image.resize(..., "nearest")``); ``"nearest"`` picks another source
  row for 118 of 473 output rows at LookIntoPerson's 473 crop.

``state_dict_from_flax(variables, "SegNet")`` carries a flax SegNet's
params and batch statistics into it (the keys are the flax module names).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .efficientnet import _same_pad


class SegNet(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.c1 = nn.Conv2d(3, 32, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(32, momentum=0.1)
        self.c2 = nn.Conv2d(32, 64, 3, stride=2)  # padded in forward, as "SAME"
        self.bn2 = nn.BatchNorm2d(64, momentum=0.1)
        self.c3 = nn.Conv2d(64, 64, 3, padding=1)
        self.bn3 = nn.BatchNorm2d(64, momentum=0.1)
        self.head = nn.Conv2d(64, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 3, H, W] images -> [N, num_classes, H, W] class logits."""
        h = F.relu(self.bn1(self.c1(x)))
        h = F.relu(self.bn2(self.c2(_same_pad(h, 3, 2))))
        h = F.relu(self.bn3(self.c3(h)))
        h = F.interpolate(h, size=x.shape[-2:], mode="nearest-exact")
        return self.head(h)
