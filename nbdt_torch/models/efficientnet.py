"""EfficientNet B0-B8 as NCHW ``nn.Module``s with pytorchcv's parameter names.

Counterpart of ``nbdt_tpu/models/efficientnet.py``: MBConv blocks with
squeeze-excite, expansion and swish under compound scaling, a 1x1 head conv,
a global mean pool and an f32 classifier. No dropout and no drop-connect, as
in the JAX module. The reference's ImageNet NBDT rides ``efficientnet_b7b``
(pytorchcv's TF-ported weights, on the ``induced-efficientnet_b7b`` tree).

The state dict carries pytorchcv's keys: ``features.init_block.conv.{conv,bn}``;
five ``features.stage{g}`` groups, broken at the stride-2 blocks, of
``unit{u}``: ``dw_conv``/``se.conv1``/``se.conv2``/``pw_conv`` where the
expand ratio is 1, ``conv1``/``conv2``/``se``/``conv3`` elsewhere;
``features.final_block.{conv,bn}`` and ``output.fc``. A pytorchcv ``.pth``
loads with ``strict=True``.

``tf_mode`` (the "b" and "c" families) pads every k x k conv as TF's "SAME"
does. At stride 2 that depends on the input's size and is asymmetric: the
pad is computed in ``forward`` and applied with ``F.pad``. At stride 1 (odd
kernels) it is ``kernel // 2`` on each side, the conv's own padding, as in
the other family, which pads ``kernel // 2`` symmetrically everywhere.

Inside the NBDT wrapper's ``backbone`` span each ``MBConv`` block runs its
layers in spans (recorded only under a profiler), with no attributes:

    backbone
      pointwise   the expansion ConvBlock (1x1 conv, BatchNorm, swish), where
                  the block expands
      depthwise   the depthwise ConvBlock: the "SAME" pad, the conv,
                  BatchNorm, swish (one pass of ``ops/dw_bn_swish.py``
                  where :func:`dw_bn_swish_rule` allows)
      se          SqueezeExcite: the mean, two 1x1 convs, swish, the sigmoid
                  and the gate's multiply
      pointwise   the projection ConvBlock (1x1 conv, BatchNorm) and the
                  residual add

The stem, ``final_block`` and the pooling run in ``backbone`` outside them.
At B7b that is 55 ``depthwise``, 55 ``se`` and 106 ``pointwise`` spans a
call. ``efficientnet_b7b`` at 600x600 is the benchmark's
``efficientnet_b7b_imagenet1000`` configuration.

``dtype`` mirrors the flax knob: with bf16 the convs (the SE's 1x1 convs
too) hold bf16 weights and compute in bf16, while every BatchNorm (eps 1e-3)
normalizes and outputs f32, so swish, the SE's mean and the residual sums
run in f32; the pooled features and the classifier are f32.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import dw_bn_swish as dw
from ..profiling import span
from .resnet import _conv, bn_act_rule, tracing

__all__ = ("EfficientNet",) + tuple(
    f"efficientnet_b{i}{s}" for i in range(9) for s in ("", "b", "c"))

# (width_mult, depth_mult, resolution, dropout)
COMPOUND = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
    "b8": (2.2, 3.6, 672, 0.5),
}

# Base B0 stage config: (expand, channels, repeats, stride, kernel)
BASE_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]

BN_EPS = 1e-3
SE_RATIO = 0.25


def round_channels(c: float, divisor: int = 8) -> int:
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new < 0.9 * c:
        new += divisor
    return new


def pytorchcv_units(repeats: Sequence[int]) -> Iterator[Tuple[int, int, str]]:
    """``(base stage, block, "features.stage{g}.unit{u}")`` for every block,
    in order, given the blocks of each of the 7 base stages: pytorchcv opens
    a new stage group at each stride-2 base stage, so its 5 groups pair 1:1
    with the base stages' flattened blocks."""
    g, units = 0, 0
    for si, ((_, _, _, stride, _), n) in enumerate(zip(BASE_STAGES, repeats)):
        if stride == 2 or si == 0:
            g, units = g + 1, 0
        for bi in range(n):
            units += 1
            yield si, bi, f"features.stage{g}.unit{units}"


def same_pads(height: int, width: int, kernel: int, stride: int) -> List[int]:
    """TF "SAME" as ``F.pad``'s (left, right, top, bottom): ``ceil(n /
    stride)`` outputs, the pad split with its smaller half first."""
    pads = []
    for n in (width, height):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    pads = same_pads(x.shape[-2], x.shape[-1], kernel, stride)
    return F.pad(x, pads) if any(pads) else x


def dw_bn_swish_rule(depthwise: bool, activate: bool, kernel: int, stride: int,
                     *bn_act_inputs) -> bool:
    """Whether a ConvBlock's conv, BatchNorm and swish run as the one
    hand-written pass of ``ops/dw_bn_swish.py``: only a depthwise conv of a
    size and stride the kernel takes, followed by swish, where
    :func:`~nbdt_torch.models.resnet.bn_act_rule` holds for
    ``bn_act_inputs`` (CUDA, f32, contiguous NCHW, eval statistics, no
    autograd, no trace). Training, bf16, channels-last and the CPU keep the
    library's passes."""
    return (depthwise and activate and kernel in dw.KERNELS and stride in dw.STRIDES
            and bn_act_rule(*bn_act_inputs))


class ConvBlock(nn.Module):
    """pytorchcv's ConvBlock: ``conv`` (no bias) then ``bn`` (f32 out), and
    swish where ``activate``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
                 activate: bool = True, tf_pad: bool = False):
        super().__init__()
        self.kernel, self.stride, self.activate = kernel, stride, activate
        self.tf_pad = tf_pad and stride > 1
        pad = 0 if self.tf_pad else kernel // 2
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        if self._fused(x):
            pads = (same_pads(x.shape[-2], x.shape[-1], self.kernel, self.stride)
                    if self.tf_pad else [self.kernel // 2] * 4)
            return dw.fused_dw_bn_swish(x.to(self.conv.weight.dtype), self.conv.weight,
                                        self.bn, self.stride, pads)
        if self.tf_pad:
            x = _same_pad(x, self.kernel, self.stride)
        h = self.bn(_conv(self.conv, x).float())
        return F.silu(h) if self.activate else h

    def _fused(self, x: torch.Tensor) -> bool:
        """:func:`dw_bn_swish_rule` read off the block and its input; the
        conv computes in its weight's dtype (``_conv`` casts ``x`` to it)."""
        conv, bn = self.conv, self.bn
        return dw_bn_swish_rule(
            conv.groups == conv.in_channels == conv.out_channels, self.activate, self.kernel,
            self.stride, x.device.type, conv.weight.dtype, x.is_contiguous(),
            bn.training or bn.running_mean is None, torch.is_grad_enabled(), tracing(x))


class SqueezeExcite(nn.Module):
    """Spatial mean, 1x1 conv (bias), swish, 1x1 conv (bias), then
    ``x * sigmoid``; ``reduced`` counts the block's input channels."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, reduced, 1)
        self.conv2 = nn.Conv2d(reduced, channels, 1)

    def forward(self, x):
        s = F.silu(_conv(self.conv1, x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(_conv(self.conv2, s))


class MBConv(nn.Module):
    """pytorchcv's EffiDwsConvUnit (``expand_ratio == 1``: ``dw_conv``,
    ``se``, ``pw_conv``) or EffiInvResUnit (``conv1`` expand, ``conv2``
    depthwise, ``se``, ``conv3`` project). The residual applies where the
    stride is 1 and the widths are equal."""

    def __init__(self, cin: int, cout: int, expand_ratio: int, stride: int, kernel: int,
                 tf_pad: bool = False):
        super().__init__()
        mid = cin * expand_ratio
        self.expand = expand_ratio != 1
        self.residual = stride == 1 and cin == cout
        if self.expand:
            self.conv1 = ConvBlock(cin, mid, 1)
        dw = ConvBlock(mid, mid, kernel, stride, groups=mid, tf_pad=tf_pad)
        se = SqueezeExcite(mid, max(1, int(cin * SE_RATIO)))
        pw = ConvBlock(mid, cout, 1, activate=False)
        self.names = ("conv2", "conv3") if self.expand else ("dw_conv", "pw_conv")
        setattr(self, self.names[0], dw)
        self.se = se
        setattr(self, self.names[1], pw)

    def forward(self, x):
        h = x
        if self.expand:
            with span("pointwise", x.device):
                h = self.conv1(x)
        with span("depthwise", x.device):
            h = getattr(self, self.names[0])(h)
        with span("se", x.device):
            h = self.se(h)
        with span("pointwise", x.device):
            h = getattr(self, self.names[1])(h)
            return h + x if self.residual else h


class EfficientNet(nn.Module):
    """EfficientNet of one compound ``variant`` ("b0" ... "b8"). Takes NCHW
    input; ``forward(x, features_only=True)`` returns the f32 pooled
    features."""

    def __init__(self, variant: str = "b0", num_classes: int = 1000, tf_mode: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.variant, self.num_classes, self.tf_mode, self.dtype = (
            variant, num_classes, tf_mode, dtype)
        wm, dm, _, _ = COMPOUND[variant]
        self.features = nn.Module()
        cin = round_channels(32 * wm)
        self.features.init_block = nn.Module()
        self.features.init_block.conv = ConvBlock(3, cin, 3, 2, tf_pad=tf_mode)
        repeats = [int(math.ceil(r * dm)) for _, _, r, _, _ in BASE_STAGES]
        for si, bi, name in pytorchcv_units(repeats):
            expand, c, _, stride, kernel = BASE_STAGES[si]
            cout = round_channels(c * wm)
            _, stage, unit = name.split(".")
            if not hasattr(self.features, stage):
                self.features.add_module(stage, nn.Sequential())
            getattr(self.features, stage).add_module(unit, MBConv(
                cin, cout, expand, stride if bi == 0 else 1, kernel, tf_pad=tf_mode))
            cin = cout
        self.num_features = round_channels(1280 * wm)
        self.features.final_block = ConvBlock(cin, self.num_features, 1)
        self.output = nn.Module()
        self.output.fc = nn.Linear(self.num_features, num_classes)
        for m in self.features.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)

    def forward(self, x, features_only: bool = False):
        f = self.features
        h = f.init_block.conv(x)
        for name, stage in f.named_children():
            if name.startswith("stage"):
                h = stage(h)
        h = f.final_block(h).mean(dim=(2, 3)).float()
        if features_only:
            return h
        return self.output.fc(h)

    def clone(self, dtype: Optional[torch.dtype] = None) -> "EfficientNet":
        """A fresh module of the same architecture in another ``dtype``; the
        caller loads its weights."""
        return EfficientNet(self.variant, self.num_classes, self.tf_mode,
                            dtype=self.dtype if dtype is None else dtype)


def _make(variant: str, tf_mode: bool = False, suffix: str = ""):
    def ctor(num_classes: int = 1000, dtype=torch.float32) -> EfficientNet:
        return EfficientNet(variant, num_classes, tf_mode=tf_mode, dtype=dtype)

    ctor.__name__ = f"efficientnet_{variant}" + (suffix or ("b" if tf_mode else ""))
    return ctor


# The plain family, pytorchcv's "b" family (TF-ported weights, "SAME"
# padding; b7b is the reference's ImageNet NBDT arch) and its "c" family
# (AdvProp weights: the same module as "b").
for _i in range(9):
    for _suffix, _tf in (("", False), ("b", True), ("c", True)):
        globals()[f"efficientnet_b{_i}{_suffix}"] = _make(f"b{_i}", _tf, _suffix)
del _i, _suffix, _tf
