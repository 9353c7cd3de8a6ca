"""AlexNet as an NCHW ``nn.Module`` with torchvision's parameter names.

Counterpart of ``nbdt_tpu/models/alexnet.py``: five ReLU convs with 3x3
stride-2 max-pools, an adaptive average pool to 6x6 (the JAX module's
``adaptive_avg_pool`` reproduces torch's bins, upsampling included, so this
is ``F.adaptive_avg_pool2d``), the channel-major flatten, and the MLP head
in f32 whatever the stream's dtype. Keys: ``features.{0,3,6,8,10}``,
``classifier.{1,4,6}`` (torchvision's dropouts at ``classifier.0/3``, which
the JAX module has not, are identities). No BatchNorm. The pooled features
that the fused head takes are ``classifier.4``'s ReLU output, 4096 wide.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .stream import Stream, ZooNet, cast_convs

__all__ = ("AlexNet", "alexnet")


class AlexNet(ZooNet):
    """Takes NCHW input; ``forward(x, features_only=True)`` returns the f32
    output of the second hidden layer."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = {"num_classes": num_classes}
        self.dtype = dtype
        self.features = Stream(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2))
        self.classifier = Stream(
            nn.Identity(), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
            nn.Identity(), nn.Linear(4096, 4096), nn.ReLU(), nn.Linear(4096, num_classes))
        cast_convs(self, dtype)

    def forward(self, x, features_only: bool = False):
        out = F.adaptive_avg_pool2d(self.features(x), (6, 6)).flatten(1).float()
        out = self.classifier[:6](out)
        if features_only:
            return out
        return self.classifier[6](out)


def alexnet(num_classes: int = 1000, dtype=torch.float32) -> AlexNet:
    return AlexNet(num_classes, dtype=dtype)
