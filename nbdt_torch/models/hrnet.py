"""HRNetV2 for semantic segmentation (NCHW, f32).

Wang et al., "Deep High-Resolution Representation Learning for Visual
Recognition" (arXiv:1908.07919), in the form of the ``seg_hrnet`` model of
HRNet-Semantic-Segmentation, the NBDT paper's segmentation backbone:

- stem: two 3x3 stride-2 convs (3 -> 64 -> 64), each with BatchNorm and ReLU;
- stage 1: four ``Bottleneck``s of 64 planes (-> 256), the first with a
  1x1 conv + BatchNorm shortcut (``downsample``);
- transitions: a 3x3 conv + BatchNorm + ReLU into each new branch (stride 2
  from the lowest resolution; stride 1 into branch 0 from stage 1);
- stages 2-4: 1, 4 and 3 modules over 2, 3 and 4 branches (48/96/192/384
  channels for W48), each ``blocks`` ``BasicBlock``s a branch, then the
  exchange unit ``y_i = ReLU(sum_j f_ij(x_j))``: identity for j = i; for
  j > i a 1x1 conv + BatchNorm, then bilinear upsampling to branch i's
  size; for j < i, i - j stride-2 3x3 convs, each with BatchNorm, a ReLU
  after every one but the last, the last to branch i's width;
- the V2 head: branches 2-4 upsampled bilinearly to branch 1's size and
  concatenated (720 channels for W48), a 1x1 conv with bias, BatchNorm,
  ReLU, and the 1x1 classifier with bias: ``[N, num_classes, H/4, W/4]``.

``align_corners`` is HRNet-Semantic-Segmentation's ``MODEL.ALIGN_CORNERS``
(True in its default configuration). Parameter names are ``seg_hrnet``'s
(``transition{1,2,3}``, ``stage{2,3,4}.M.branches.B.K``,
``stage{2,3,4}.M.fuse_layers.I.J``, ``last_layer.{0,1,3}``), so a released
checkpoint loads with ``strict=True`` once its trainer's ``model.`` prefix is
removed; ``classifier`` is ``last_layer[3]``.

Inside the NBDT wrapper's ``backbone`` span, each module runs its blocks in
a ``branches`` span and its exchange unit in a ``fuse`` span, both with the
attributes ``stage`` and ``module`` (recorded only under a profiler). The
blocks run inside ``layout.timed_conv_engines``: where the layout rule gives
NCHW (CUDA, f32, TF32 off) cuDNN times its engines for their convolutions
instead of picking by heuristic, which chose a slow FFT at these shapes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..profiling import span
from .layout import timed_conv_engines
from .resnet import BasicBlock, Bottleneck


def _conv_bn(cin: int, cout: int, kernel: int, stride: int, relu: bool) -> nn.Sequential:
    layers = [nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False),
              nn.BatchNorm2d(cout)]
    return nn.Sequential(*layers, nn.ReLU(inplace=True)) if relu else nn.Sequential(*layers)


def _link(widths: Sequence[int], i: int, j: int) -> Optional[nn.Module]:
    """The exchange unit's path from branch ``j`` to branch ``i``."""
    if j == i:
        return None
    if j > i:
        return _conv_bn(widths[j], widths[i], 1, 1, relu=False)
    steps = i - j
    return nn.Sequential(*[
        _conv_bn(widths[j], widths[i] if k == steps - 1 else widths[j], 3, 2, relu=k < steps - 1)
        for k in range(steps)])


def _transition(widths_in: Sequence[int], widths: Sequence[int]) -> nn.ModuleList:
    """Into the next stage's branches: a conv where a branch changes width,
    and a stride-2 conv from the lowest resolution into each new branch."""
    layers = []
    for i, width in enumerate(widths):
        if i < len(widths_in):
            same = widths_in[i] == width
            layers.append(None if same else _conv_bn(widths_in[i], width, 3, 1, relu=True))
        else:
            layers.append(nn.Sequential(_conv_bn(widths_in[-1], width, 3, 2, relu=True)))
    return nn.ModuleList(layers)


def _upsample(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)


class HRModule(nn.Module):
    """One module of a stage: ``blocks`` BasicBlocks on each branch, then
    the exchange unit, which gives every branch the sum of all of them."""

    def __init__(self, widths: Sequence[int], blocks: int, stage: int, index: int,
                 align_corners: bool):
        super().__init__()
        self.stage, self.index, self.align_corners = stage, index, align_corners
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(w, w) for _ in range(blocks)]) for w in widths)
        self.fuse_layers = nn.ModuleList(
            nn.ModuleList(_link(widths, i, j) for j in range(len(widths)))
            for i in range(len(widths)))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        attrs = {"stage": self.stage, "module": self.index}
        with timed_conv_engines(xs[0]), span("branches", xs[0].device, **attrs):
            xs = [branch(x) for branch, x in zip(self.branches, xs)]
        with span("fuse", xs[0].device, **attrs):
            return [self._fused(xs, i) for i in range(len(xs))]

    def _fused(self, xs: List[torch.Tensor], i: int) -> torch.Tensor:
        y = None
        for j, (x, link) in enumerate(zip(xs, self.fuse_layers[i])):
            if j != i:
                x = link(x)
                if j > i:
                    x = _upsample(x, xs[i].shape[-2:], self.align_corners)
            y = x if y is None else y + x
        return F.relu(y)


class HRNetV2(nn.Module):
    """HRNetV2: NCHW images -> ``[N, num_classes, H/4, W/4]`` class logits."""

    def __init__(self, num_classes: int = 150, widths: Sequence[int] = (48, 96, 192, 384),
                 blocks: int = 4, modules: Sequence[int] = (1, 4, 3), stem_width: int = 64,
                 align_corners: bool = True):
        super().__init__()
        if len(modules) != len(widths) - 1:
            raise ValueError(f"{len(widths)} branches take {len(widths) - 1} stages of "
                             f"modules, not {len(modules)}")
        self.num_classes, self.align_corners = num_classes, align_corners
        self.conv1 = nn.Conv2d(3, stem_width, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(stem_width)
        self.conv2 = nn.Conv2d(stem_width, stem_width, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(stem_width)
        out = stem_width * Bottleneck.expansion
        self.layer1 = nn.Sequential(*[
            Bottleneck(stem_width if k == 0 else out, stem_width, shortcut_name="downsample")
            for k in range(4)])
        widths_in = [out]
        for stage, count in enumerate(modules, start=2):
            cur = list(widths[:stage])
            setattr(self, f"transition{stage - 1}", _transition(widths_in, cur))
            setattr(self, f"stage{stage}", nn.Sequential(*[
                HRModule(cur, blocks, stage, m, align_corners) for m in range(count)]))
            widths_in = cur
        self.stages = len(modules)
        dim = sum(widths)
        self.last_layer = nn.Sequential(nn.Conv2d(dim, dim, 1), nn.BatchNorm2d(dim),
                                        nn.ReLU(inplace=True), nn.Conv2d(dim, num_classes, 1))

    @property
    def classifier(self) -> nn.Conv2d:
        return self.last_layer[3]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for stage in range(2, 2 + self.stages):
            transition = getattr(self, f"transition{stage - 1}")
            xs = [xs[i] if t is None else t(xs[min(i, len(xs) - 1)])
                  for i, t in enumerate(transition)]
            xs = getattr(self, f"stage{stage}")(xs)
        size = xs[0].shape[-2:]
        x = torch.cat([xs[0]] + [_upsample(y, size, self.align_corners) for y in xs[1:]], 1)
        return self.last_layer(x)


def hrnetv2_w48(num_classes: int = 150, align_corners: bool = True) -> HRNetV2:
    """HRNetV2-W48, the widths of the ADE20K and Cityscapes models."""
    return HRNetV2(num_classes, (48, 96, 192, 384), 4, (1, 4, 3), 64, align_corners)
