"""WideResNet-28-10 as an NCHW ``nn.Module`` with pytorchcv parameter names.

Counterpart of ``nbdt_tpu/models/wideresnet.py``. The reference re-exports
pytorchcv's ``wrn28_10_cifar10/cifar100`` and a ``wrn28_10`` whose 8x8 final
pool becomes a global average pool for TinyImagenet's 64x64 inputs. The
network is pre-activation: a bare 3x3 init conv, three stages of pre-act
units (BN-ReLU-conv3x3 twice; on a resize, a 1x1 shortcut of the
*pre-activated* input), a trailing BN-ReLU, global average pool, and an
``output`` linear head.

The state dict carries pytorchcv's keys (``features.init_block.weight``,
``features.stageS.unitU.body.convN.{bn,conv}``,
``features.stageS.unitU.identity_conv.weight``, ``features.post_activ.bn``,
``output``), so a released reference ``.pth`` loads strictly.

``dtype`` mirrors the flax knob as the port's ResNet does: with bf16 the
convs hold bf16 weights and compute in bf16, every BatchNorm normalizes in
f32 (torch's momentum 0.1 and eps 1e-5, flax's 0.9 and 1e-5), and the
pooled features are cast to f32 before the f32 ``output`` head.
``bn_impl="bf16"`` runs each BatchNorm in the stream dtype, as the port's
ResNet does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import _check_bn_impl, _conv, _norm

__all__ = ("PreResBlock", "WRN", "wrn28_10", "wrn28_10_cifar10", "wrn28_10_cifar100",
           "model_urls")

# Released plain-backbone checkpoint (the JAX package's table).
model_urls = {
    ("wrn28_10", "TinyImagenet200"):
        "https://github.com/alvinwan/neural-backed-decision-trees/releases/"
        "download/0.0.1/ckpt-TinyImagenet200-wrn28_10.pth",
}


class _PreConv(nn.Module):
    """pytorchcv's PreConvBlock: ``bn`` then ``conv``; forward returns the
    conv output and the pre-activation ``relu(bn(x))``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, bn_f32: bool):
        super().__init__()
        self.bn_f32 = bn_f32
        self.bn = nn.BatchNorm2d(in_channels)
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=False)

    def forward(self, x):
        pre = F.relu(_norm(self.bn, x, self.bn_f32))
        return _conv(self.conv, pre), pre


class PreResBlock(nn.Module):
    """Pre-activation basic unit: (BN-ReLU-conv3x3) x2 + shortcut. On a
    resize (stride != 1 or a channel change) the shortcut is the 1x1
    ``identity_conv`` of the pre-activated input, else the raw input."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 bn_f32: bool = True):
        super().__init__()
        self.body = nn.ModuleDict({"conv1": _PreConv(in_channels, out_channels, stride, bn_f32),
                                   "conv2": _PreConv(out_channels, out_channels, 1, bn_f32)})
        self.resize = stride != 1 or in_channels != out_channels
        if self.resize:
            self.identity_conv = nn.Conv2d(in_channels, out_channels, 1, stride, bias=False)

    def forward(self, x):
        out, pre = self.body["conv1"](x)
        out, _ = self.body["conv2"](out)
        identity = _conv(self.identity_conv, pre) if self.resize else x
        return out + identity


class _PostActiv(nn.Module):
    def __init__(self, channels: int, bn_f32: bool):
        super().__init__()
        self.bn_f32 = bn_f32
        self.bn = nn.BatchNorm2d(channels)

    def forward(self, x):
        return F.relu(_norm(self.bn, x, self.bn_f32))


class WRN(nn.Module):
    """WideResNet for 32x32 and 64x64 inputs (pytorchcv's CIFARWRN layout).
    Takes NCHW input; ``forward(x, features_only=True)`` returns the f32
    pooled features."""

    def __init__(self, depth: int = 28, width: int = 10, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, bn_impl: str = "f32"):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"WRN depth must be 6n + 4, not {depth}")
        self.depth, self.width, self.num_classes, self.dtype = depth, width, num_classes, dtype
        self.bn_impl = bn_impl
        bn_f32 = _check_bn_impl(bn_impl)
        units = (depth - 4) // 6  # units a stage: 4 at depth 28
        self.features = nn.Module()
        self.features.init_block = nn.Conv2d(3, 16, 3, 1, 1, bias=False)
        cin = 16
        for stage, (w, stride) in enumerate(zip((16 * width, 32 * width, 64 * width),
                                                (1, 2, 2)), start=1):
            seq = nn.Sequential()
            for u in range(units):
                seq.add_module(f"unit{u + 1}",
                               PreResBlock(cin, w, stride if u == 0 else 1, bn_f32))
                cin = w
            self.features.add_module(f"stage{stage}", seq)
        self.features.post_activ = _PostActiv(cin, bn_f32)
        self.output = nn.Linear(cin, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)

    def forward(self, x, features_only: bool = False):
        f = self.features
        out = _conv(f.init_block, x)
        out = f.stage3(f.stage2(f.stage1(out)))
        # global average pool: pytorchcv's AvgPool2d(8) at 32px, the
        # reference's adaptive pool at 64px
        out = f.post_activ(out).mean(dim=(2, 3)).float()
        if features_only:
            return out
        return self.output(out)

    def clone(self, dtype: Optional[torch.dtype] = None,
              bn_impl: Optional[str] = None) -> "WRN":
        """A fresh module of the same architecture in another ``dtype`` or
        ``bn_impl``; the caller loads its weights."""
        return WRN(self.depth, self.width, self.num_classes,
                   dtype=self.dtype if dtype is None else dtype,
                   bn_impl=self.bn_impl if bn_impl is None else bn_impl)


def wrn28_10(num_classes: int = 200, dtype=torch.float32) -> WRN:
    """The TinyImagenet200 variant (global pool at 64px)."""
    return WRN(28, 10, num_classes, dtype=dtype)


def wrn28_10_cifar10(num_classes: int = 10, dtype=torch.float32) -> WRN:
    return WRN(28, 10, num_classes, dtype=dtype)


def wrn28_10_cifar100(num_classes: int = 100, dtype=torch.float32) -> WRN:
    return WRN(28, 10, num_classes, dtype=dtype)
