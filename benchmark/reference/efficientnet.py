"""Plain EfficientNet (Tan & Le, arXiv:1905.11946) in the form of
pytorchcv's TF-ported ``efficientnet_b*b``: TF "SAME" padding and BatchNorm
eps 1e-3. NCHW, f32.

- Compound scaling of B0's stages (expand ratio, channels, repeats, stride,
  kernel: (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
  (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3)):
  widths ``round_channels(c * width_mult)`` (a multiple of 8, never under
  90% of ``c * width_mult``), repeats ``ceil(r * depth_mult)``; the stride
  on a stage's first block only.
- Stem: 3x3 conv at stride 2 to ``round_channels(32 * width_mult)``,
  BatchNorm, swish.
- MBConv: a 1x1 expansion to ``expand * cin`` with BatchNorm and swish
  where the ratio is not 1; a k x k depthwise conv with BatchNorm and swish;
  squeeze-excite (the spatial mean, a 1x1 conv with bias to
  ``max(1, int(cin * 0.25))``, swish, a 1x1 conv with bias back, a sigmoid
  gate on the input); a 1x1 projection with BatchNorm; the block's input
  added where the stride is 1 and the widths are equal.
- Head: 1x1 conv to ``round_channels(1280 * width_mult)``, BatchNorm,
  swish, the global mean, a linear classifier.
- TF "SAME": a k x k conv at stride s gives ``ceil(n / s)`` outputs; the
  pad, ``(ceil(n / s) - 1) * s + k - n``, goes with its smaller half first
  (top, left). At stride 1 (odd kernels) that is ``k // 2`` a side.

Departures from the published model: no dropout and no drop-connect (eval);
the evaluation transform (a resize to 632 and a centre crop of 600 at B7) is
left to the caller.

Parameter names are pytorchcv's (``features.init_block.conv.{conv,bn}``,
``features.stage{g}.unit{u}`` with ``conv1``, ``conv2``, ``se``, ``conv3``
where a block expands and ``dw_conv``, ``se``, ``pw_conv`` where it does
not, ``features.final_block.{conv,bn}``, ``output.fc``), so one state dict
loads into this module and into the program's. pytorchcv opens a new
``stage{g}`` at each of B0's stages that starts with stride 2, and at the
first.

:func:`depthwise_work` counts the depthwise convs' operations and bytes
from the shapes, for their roofline.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# B0: (expand ratio, channels, repeats, stride, kernel) of each stage
B0_STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
             (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))
STEM, HEAD, SE_RATIO = 32, 1280, 0.25


def round_channels(c: float, divisor: int = 8) -> int:
    rounded = max(divisor, int(c + divisor / 2) // divisor * divisor)
    return rounded + divisor if rounded < 0.9 * c else rounded


def same_out(n: int, stride: int) -> int:
    """Outputs of a side of ``n`` under TF "SAME" at ``stride``."""
    return math.ceil(n / stride)


class ConvBN(nn.Module):
    """A bias-free conv (TF "SAME"), BatchNorm and, with ``swish``, swish."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, groups: int,
                 swish: bool, eps: float):
        super().__init__()
        self.kernel, self.stride, self.swish = kernel, stride, swish
        self.conv = nn.Conv2d(cin, cout, kernel, stride, 0, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=eps)

    def forward(self, x):
        pads = []
        for n in (x.shape[3], x.shape[2]):  # F.pad's order: width, then height
            total = max((same_out(n, self.stride) - 1) * self.stride + self.kernel - n, 0)
            pads += [total // 2, total - total // 2]
        out = self.bn(self.conv(F.pad(x, pads) if any(pads) else x))
        return F.silu(out) if self.swish else out


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, reduced, 1)
        self.conv2 = nn.Conv2d(reduced, channels, 1)

    def forward(self, x):
        s = self.conv2(F.silu(self.conv1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, expand: int, stride: int, kernel: int, eps: float):
        super().__init__()
        mid = cin * expand
        self.expands, self.residual = expand != 1, stride == 1 and cin == cout
        if self.expands:
            self.conv1 = ConvBN(cin, mid, 1, 1, 1, True, eps)
        depthwise = ConvBN(mid, mid, kernel, stride, mid, True, eps)
        self.se = SqueezeExcite(mid, max(1, int(cin * SE_RATIO)))
        project = ConvBN(mid, cout, 1, 1, 1, False, eps)
        if self.expands:
            self.conv2, self.conv3 = depthwise, project
        else:
            self.dw_conv, self.pw_conv = depthwise, project

    @property
    def depthwise(self) -> ConvBN:
        return self.conv2 if self.expands else self.dw_conv

    def forward(self, x):
        h = self.conv1(x) if self.expands else x
        h = self.se(self.depthwise(h))
        h = (self.conv3 if self.expands else self.pw_conv)(h)
        return h + x if self.residual else h


class Features(nn.Module):
    """The stem, the blocks and the head conv; called, the pooled features
    ``[B, round_channels(1280 * width_mult)]`` of NCHW images."""

    def __init__(self, width_mult: float, depth_mult: float, eps: float):
        super().__init__()
        self.init_block = nn.Module()
        cin = round_channels(STEM * width_mult)
        self.init_block.conv = ConvBN(3, cin, 3, 2, 1, True, eps)
        group = 0
        for i, (expand, channels, repeats, stride, kernel) in enumerate(B0_STAGES):
            if i == 0 or stride == 2:
                group += 1
                self.add_module(f"stage{group}", nn.Sequential())
            stage = getattr(self, f"stage{group}")
            cout = round_channels(channels * width_mult)
            for b in range(math.ceil(repeats * depth_mult)):
                stage.add_module(f"unit{len(stage) + 1}", MBConv(
                    cin, cout, expand, stride if b == 0 else 1, kernel, eps))
                cin = cout
        self.final_block = ConvBN(cin, round_channels(HEAD * width_mult), 1, 1, 1, True, eps)

    def blocks(self) -> list:
        """The MBConv blocks in order."""
        return [m for m in self.modules() if isinstance(m, MBConv)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.init_block.conv(x)
        for block in self.blocks():
            h = block(h)
        return self.final_block(h).mean(dim=(2, 3))


class EfficientNet(nn.Module):
    """``features(x)``: the pooled features; ``forward(x)``: the logits."""

    def __init__(self, width_mult: float, depth_mult: float, num_classes: int, eps: float):
        super().__init__()
        self.features = Features(width_mult, depth_mult, eps)
        self.output = nn.Module()
        self.output.fc = nn.Linear(round_channels(HEAD * width_mult), num_classes)

    @classmethod
    def from_sizes(cls, sizes: dict) -> "EfficientNet":
        """The model of a configuration's ``model`` sizes (the "b" family:
        ``same_padding`` true)."""
        if not sizes["same_padding"]:
            raise ValueError("the reference pads as TF's SAME does: same_padding must be true")
        return cls(sizes["width_mult"], sizes["depth_mult"], sizes["num_classes"],
                   sizes["bn_eps"])

    @property
    def classifier(self) -> nn.Linear:
        return self.output.fc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output.fc(self.features(x))


def depthwise_work(sizes: dict, batch: int) -> dict:
    """The depthwise convs' work on ``batch`` images of a configuration's
    ``model`` sizes, from the shapes: 2 k^2 C operations an output pixel; in
    f32, each conv's input read once (unpadded), its output written once and
    its weights read once."""
    with torch.device("meta"):
        model = EfficientNet.from_sizes(sizes)
    n = same_out(sizes["image_size"], 2)  # after the stem
    flops = nbytes = 0
    for block in model.features.blocks():
        conv = block.depthwise.conv
        c, k, s = conv.out_channels, conv.kernel_size[0], conv.stride[0]
        out = same_out(n, s)
        flops += 2 * k * k * c * out * out * batch
        nbytes += 4 * (c * n * n * batch + c * out * out * batch + c * k * k)
        n = out
    return {"flops": flops, "bytes": nbytes}
