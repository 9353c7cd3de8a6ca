"""VGG 11/13/16/19, plain and with BatchNorm, as NCHW ``nn.Module``s with
torchvision's parameter names.

Counterpart of ``nbdt_tpu/models/vgg.py``: 3x3 convs, each with a bias (in
both variants, as torchvision's), [BatchNorm,] ReLU, 2x2 max-pools between
stages, under ``features.{i}`` at torchvision's Sequential indices. Two
heads:

* ``classic_head=True``: torchvision's exact head, an adaptive average pool
  to 7x7, the channel-major flatten and ``classifier.{0,3,6}`` in f32 (its
  dropouts at ``classifier.2/5`` are identities, as the JAX module has
  none). The fused head takes ``classifier.3``'s ReLU output, 4096 wide.
* ``classic_head=False`` (the default): the JAX module's collapsed head, the
  f32 global mean and one ``classifier`` Linear, 512 wide. It has no
  torchvision form: ``nbdt_tpu.models.convert.flax_to_torch_state_dict``
  raises on it, and :func:`nbdt_torch.models.state_dict_from_flax` maps it
  to this module's own ``classifier.weight`` and ``classifier.bias``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .stream import Stream, ZooNet, cast_convs

__all__ = ("VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "CONFIGS")

CONFIGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
         512, 512, 512, 512, "M"),
}


class VGG(ZooNet):
    """Takes NCHW input; ``forward(x, features_only=True)`` returns the f32
    features the classifier takes (4096 wide with the classic head, 512
    without)."""

    def __init__(self, depth: int = 16, num_classes: int = 1000, batch_norm: bool = True,
                 classic_head: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = {"depth": depth, "num_classes": num_classes, "batch_norm": batch_norm,
                       "classic_head": classic_head}
        self.dtype, self.classic_head = dtype, classic_head
        layers, cin = [], 3
        for v in CONFIGS[depth]:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [nn.Conv2d(cin, v, 3, padding=1),
                       *([nn.BatchNorm2d(v)] if batch_norm else []), nn.ReLU()]
            cin = v
        self.features = Stream(*layers)
        if classic_head:
            self.classifier = Stream(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Identity(),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Identity(), nn.Linear(4096, num_classes))
        else:
            self.classifier = nn.Linear(512, num_classes)
        cast_convs(self, dtype)

    def forward(self, x, features_only: bool = False):
        out = self.features(x)
        if self.classic_head:
            out = self.classifier[:6](F.adaptive_avg_pool2d(out, (7, 7)).flatten(1).float())
            head = self.classifier[6]
        else:
            out, head = out.mean(dim=(2, 3)).float(), self.classifier
        if features_only:
            return out
        return head(out)


def _make(depth: int, batch_norm: bool):
    def ctor(num_classes: int = 1000, dtype=torch.float32, classic_head: bool = False) -> VGG:
        return VGG(depth, num_classes, batch_norm, classic_head, dtype=dtype)

    ctor.__name__ = f"vgg{depth}" + ("_bn" if batch_norm else "")
    return ctor


vgg11, vgg13, vgg16, vgg19 = (_make(d, False) for d in (11, 13, 16, 19))
vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn = (_make(d, True) for d in (11, 13, 16, 19))
