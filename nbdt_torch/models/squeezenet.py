"""SqueezeNet 1.0 and 1.1 as NCHW ``nn.Module``s with torchvision's
parameter names.

Counterpart of ``nbdt_tpu/models/squeezenet.py``: Fire modules (a 1x1
squeeze, then parallel 1x1 and 3x3 expands, concatenated), ceil-mode 3x3
stride-2 max-pools, and torchvision's fully convolutional classifier: a 1x1
conv (``classifier.1``, its ``[C, 512, 1, 1]`` weight the class-embedding
matrix that induction takes), ReLU, then the global mean. No BatchNorm.

The classifier conv sits before the ReLU and the mean, so the logits are no
linear function of pooled features: ``forward(x, features_only=True)``
raises ``NotImplementedError``, as the JAX module does, and
``SoftNBDT(fused=True)`` on a SqueezeNet raises at its first call. It
serves through the plain rules.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .stream import Stream, ZooNet, cast_convs

__all__ = ("SqueezeNet", "squeezenet1_0", "squeezenet1_1")

# torchvision's features Sequential: ("conv", (width, kernel)) at index 0,
# then "pool" or ("fire", (squeeze, expand1x1, expand3x3)); ReLU at 1
LAYOUTS = {
    "1_0": (("conv", (96, 7)), "pool", ("fire", (16, 64, 64)), ("fire", (16, 64, 64)),
            ("fire", (32, 128, 128)), "pool", ("fire", (32, 128, 128)),
            ("fire", (48, 192, 192)), ("fire", (48, 192, 192)), ("fire", (64, 256, 256)),
            "pool", ("fire", (64, 256, 256))),
    "1_1": (("conv", (64, 3)), "pool", ("fire", (16, 64, 64)), ("fire", (16, 64, 64)),
            "pool", ("fire", (32, 128, 128)), ("fire", (32, 128, 128)), "pool",
            ("fire", (48, 192, 192)), ("fire", (48, 192, 192)), ("fire", (64, 256, 256)),
            ("fire", (64, 256, 256))),
}


class Fire(nn.Module):
    def __init__(self, cin: int, squeeze: int, expand1x1: int, expand3x3: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand1x1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand3x3, 3, padding=1)

    def forward(self, x):
        s = torch.relu(self.squeeze(x.to(self.squeeze.weight.dtype)))
        return torch.cat([torch.relu(self.expand1x1(s)), torch.relu(self.expand3x3(s))], dim=1)


class SqueezeNet(ZooNet):
    """Takes NCHW input; returns the logits in the stream's dtype, as JAX."""

    def __init__(self, version: str = "1_0", num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = {"version": version, "num_classes": num_classes}
        self.dtype = dtype
        layers, c = [], 3
        for spec in LAYOUTS[version]:
            if spec == "pool":
                layers.append(nn.MaxPool2d(3, 2, ceil_mode=True))
            elif spec[0] == "conv":
                width, kernel = spec[1]
                layers += [nn.Conv2d(c, width, kernel, 2), nn.ReLU()]
                c = width
            else:
                layers.append(Fire(c, *spec[1]))
                c = spec[1][1] + spec[1][2]
        self.features = Stream(*layers)
        self.classifier = Stream(nn.Identity(), nn.Conv2d(c, num_classes, 1), nn.ReLU())
        cast_convs(self, dtype)

    def forward(self, x, features_only: bool = False):
        x = self.features(x)
        if features_only:
            raise NotImplementedError(
                "SqueezeNet's classifier is a 1x1 conv applied BEFORE the ReLU and global "
                "pool (logits = mean(relu(conv(x)))), so no exact (features, linear) "
                "decomposition exists for the fused traversal head; use the standard logits "
                "path.")
        return self.classifier(x).mean(dim=(2, 3))


def squeezenet1_0(num_classes: int = 1000, dtype=torch.float32) -> SqueezeNet:
    return SqueezeNet("1_0", num_classes, dtype=dtype)


def squeezenet1_1(num_classes: int = 1000, dtype=torch.float32) -> SqueezeNet:
    return SqueezeNet("1_1", num_classes, dtype=dtype)
