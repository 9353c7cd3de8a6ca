"""Plain HRNetV2 for semantic segmentation (Wang et al., arXiv:1908.07919),
as HRNet-Semantic-Segmentation's ``seg_hrnet`` computes it. NCHW, f32.

- Stem: two 3x3 stride-2 convs (3 -> 64 -> 64), each with BatchNorm, ReLU.
- Stage 1: four Bottlenecks (1x1, 3x3, 1x1 at 64 planes, 4x expansion; a
  1x1 conv + BatchNorm shortcut on the first).
- Transitions: 3x3 conv + BatchNorm + ReLU into each new branch, stride 2
  from the lowest-resolution branch (stride 1 into branch 0 from stage 1).
- Stages 2-4: 1, 4 and 3 modules over 2, 3 and 4 branches (48, 96, 192, 384
  channels at W48); a module runs 4 BasicBlocks a branch, then its
  exchange unit ``y_i = ReLU(sum_j f_ij(x_j))``: the identity for j = i; a
  1x1 conv + BatchNorm and bilinear upsampling to branch i's size for
  j > i; for j < i, i - j stride-2 3x3 convs with BatchNorm, ReLU after
  all but the last, the last one to branch i's width.
- V2 head: branches 2-4 upsampled bilinearly to branch 1's size and
  concatenated (720 channels), a 1x1 conv with bias, BatchNorm, ReLU, and
  the classifier, a 1x1 conv with bias.

Departures from the published model: the output is left at stride 4 (HRNet's
evaluator upsamples the logits to the label's size; NBDT's ``SegNBDT`` takes
the model's maps as they come), and ``forward`` returns the class logits as
rows, one a pixel (``[N * h * w, classes]``, ordered n, h, w), so that the
benchmark's soft rules, calibration and work counts take them as they take a
classifier's; ``features`` gives the 720-wide rows before the classifier.

Parameter names are ``seg_hrnet``'s (``layer1.K.downsample``,
``transition{1,2,3}``, ``stage{S}.M.branches``, ``stage{S}.M.fuse_layers``,
``last_layer.{0,1,3}``), so one state dict loads into this module and into
the program's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.resnet import BasicBlock


def conv_bn(cin: int, cout: int, kernel: int, stride: int, relu: bool) -> nn.Sequential:
    layers = [nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False),
              nn.BatchNorm2d(cout)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int):
        super().__init__()
        cout = 4 * planes
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1, bias=False), nn.BatchNorm2d(cout))
                           if cin != cout else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


def upsample(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)


class Module(nn.Module):
    """One module of a stage: the branches' blocks, then the exchange unit."""

    def __init__(self, widths, blocks: int, align_corners: bool):
        super().__init__()
        self.align_corners = align_corners
        self.branches = nn.ModuleList(nn.Sequential(*[BasicBlock(w, w, 1) for _ in range(blocks)])
                                      for w in widths)
        rows = []
        for i in range(len(widths)):
            row = []
            for j in range(len(widths)):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(conv_bn(widths[j], widths[i], 1, 1, relu=False))
                else:
                    row.append(nn.Sequential(*[
                        conv_bn(widths[j], widths[i] if k == i - j - 1 else widths[j], 3, 2,
                                relu=k < i - j - 1)
                        for k in range(i - j)]))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = xs[0] if i == 0 else row[0](xs[0])
            for j in range(1, len(xs)):
                if j == i:
                    y = y + xs[j]
                elif j > i:
                    y = y + upsample(row[j](xs[j]), xs[i].shape[-2:], self.align_corners)
                else:
                    y = y + row[j](xs[j])
            out.append(F.relu(y))
        return out


class HRNetV2(nn.Module):
    def __init__(self, num_classes: int = 150, widths=(48, 96, 192, 384), blocks: int = 4,
                 modules=(1, 4, 3), stem_width: int = 64, align_corners: bool = True):
        super().__init__()
        self.align_corners = align_corners
        self.conv1 = nn.Conv2d(3, stem_width, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(stem_width)
        self.conv2 = nn.Conv2d(stem_width, stem_width, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(stem_width)
        self.layer1 = nn.Sequential(*[Bottleneck(stem_width if k == 0 else 4 * stem_width,
                                                 stem_width) for k in range(4)])
        before = [4 * stem_width]
        self.num_stages = len(modules)
        for s, count in enumerate(modules, start=2):
            now = list(widths[:s])
            transition = []
            for i, w in enumerate(now):
                if i < len(before):
                    transition.append(None if before[i] == w else conv_bn(before[i], w, 3, 1, True))
                else:
                    transition.append(nn.Sequential(conv_bn(before[-1], w, 3, 2, True)))
            setattr(self, f"transition{s - 1}", nn.ModuleList(transition))
            setattr(self, f"stage{s}", nn.Sequential(*[Module(now, blocks, align_corners)
                                                       for _ in range(count)]))
            before = now
        dim = sum(widths)
        self.last_layer = nn.Sequential(nn.Conv2d(dim, dim, 1), nn.BatchNorm2d(dim), nn.ReLU(),
                                        nn.Conv2d(dim, num_classes, 1))

    @classmethod
    def from_sizes(cls, sizes: dict) -> "HRNetV2":
        """The model of a configuration's ``model`` sizes."""
        if sum(sizes["widths"]) != sizes["feature_dim"]:
            raise ValueError(f"feature_dim {sizes['feature_dim']} is not the sum of the widths")
        return cls(sizes["num_classes"], sizes["widths"], sizes["blocks"], sizes["modules"],
                   sizes["stem_width"], sizes["align_corners"])

    @property
    def classifier(self) -> nn.Conv2d:
        return self.last_layer[3]

    def maps(self, x: torch.Tensor) -> torch.Tensor:
        """The 720-channel maps before the classifier, ``[N, 720, H/4, W/4]``."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s in range(2, 2 + self.num_stages):
            transition = getattr(self, f"transition{s - 1}")
            new = []
            for i, t in enumerate(transition):
                if t is None:
                    new.append(xs[i])
                else:
                    new.append(t(xs[i] if i < len(xs) else xs[-1]))
            xs = getattr(self, f"stage{s}")(new)
        size = xs[0].shape[-2:]
        x = torch.cat([xs[0]] + [upsample(y, size, self.align_corners) for y in xs[1:]], 1)
        return self.last_layer[:3](x)

    @staticmethod
    def rows(maps: torch.Tensor) -> torch.Tensor:
        return maps.permute(0, 2, 3, 1).reshape(-1, maps.shape[1])

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """One 720-wide feature row a pixel, ``[N * h * w, 720]``."""
        return self.rows(self.maps(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Per-pixel class logits as rows, ``[N * h * w, classes]``."""
        return self.rows(self.classifier(self.maps(x)))
