"""ResNet backbones as NCHW ``nn.Module``s: the CIFAR ResNets and torchvision's
ImageNet ResNets, ResNeXts and wide ResNets.

Counterpart of ``nbdt_tpu/models/resnet.py``. ``BasicBlock`` and
``Bottleneck`` (with torchvision's ``groups``/``base_width``), four stages,
global average pool, a linear head. The CIFAR stem is a 3x3 conv without a
max-pool; ``imagenet_stem=True`` is torchvision's (7x7 stride-2 conv, BN,
ReLU, 3x3 stride-2 max-pool).

Parameter names follow the two grammars of the JAX package's exporter: the
CIFAR ResNets (the capitalised ``ResNet10`` ... ``ResNet152``) carry the
reference's ``shortcut.0/.1`` and ``linear``, the torchvision ones (the
lowercase ``resnet18`` ... ``wide_resnet101_2``, ``imagenet_stem=True``)
torchvision's ``downsample.0/.1`` and ``fc``, so that either's ``.pth``
loads with ``strict=True``.

``dtype`` mirrors the flax knob: with bf16 the convs hold bf16 weights and
compute in bf16, every BatchNorm normalizes in f32, and the pooled features
are cast to f32 before the f32 head. ``bn_impl="bf16"`` instead runs each
BatchNorm in the stream dtype, as flax does with ``dtype=self.dtype`` and
``force_float32_reductions=False`` (with an f32 stream that is the f32
norm). ``folded=True`` is the serving variant with the BatchNorms baked into
conv biases (:func:`nbdt_torch.models.fold.fold_batchnorm`); there the
activations stay in ``dtype`` end to end.

Each BatchNorm that a ReLU follows, with the residual add where there is
one, runs as one pass over its conv's output, written in place, by the
hand-written kernel of ``ops/bn_act.py`` where :func:`bn_act_rule` allows
(f32 eval on the card); everywhere else as ``F.relu(bn(y) [+ shortcut])``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bn_act import fused_bn_act

BN_IMPLS = ("f32", "bf16")

# Released plain-backbone checkpoints (the JAX package's table): what the
# CLI's ``--pretrained`` takes before the NBDT-trained ones of
# ``nbdt_torch.model.model_urls``.
_RELEASES = "https://github.com/alvinwan/neural-backed-decision-trees/releases/download/0.0.1"
model_urls = {
    ("ResNet10", "CIFAR10"): f"{_RELEASES}/ckpt-CIFAR10-ResNet10.pth",
    ("ResNet10", "CIFAR100"): f"{_RELEASES}/ckpt-CIFAR100-ResNet10.pth",
    ("ResNet18", "CIFAR10"): f"{_RELEASES}/ckpt-CIFAR10-ResNet18.pth",
    ("ResNet18", "CIFAR100"): f"{_RELEASES}/ckpt-CIFAR100-ResNet18.pth",
    ("ResNet18", "TinyImagenet200"): f"{_RELEASES}/ckpt-TinyImagenet200-ResNet18.pth",
}


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.to(conv.weight.dtype))


def _norm(bn: Optional[nn.BatchNorm2d], x: torch.Tensor, f32: bool = True) -> torch.Tensor:
    """``bn`` in f32 (the default), or in ``x``'s dtype with ``f32=False``
    (``bn_impl="bf16"``); no norm where the model is folded."""
    if bn is None:
        return x
    return bn(x.float() if f32 else x)


def bn_act_rule(device_type: str, dtype: torch.dtype, contiguous: bool, batch_stats: bool,
                grad_enabled: bool, tracing: bool) -> bool:
    """Whether a BatchNorm, the residual add and the ReLU after a conv run as
    the one hand-written pass of ``ops/bn_act.py``: only for a CUDA f32
    output in contiguous NCHW (the layout rule's f32 serving layout), a
    BatchNorm on its running statistics, no autograd and no
    ``torch.compile`` or ``torch.export`` trace. Training needs batch
    statistics and a backward, and a trace has no tensor to hand the kernel,
    so both keep the library's passes, as bf16, channels-last and the CPU
    do."""
    return (device_type == "cuda" and dtype == torch.float32 and contiguous
            and not batch_stats and not grad_enabled and not tracing)


def _fused(y: torch.Tensor, *norms: Optional[nn.BatchNorm2d],
           residual: Optional[torch.Tensor] = None) -> bool:
    """:func:`bn_act_rule` read off a conv output ``y``, its BatchNorm
    ``norms[0]`` (None where folded: no pass to fuse), the shortcut's, and
    the residual."""
    if norms[0] is None:
        return False
    return bn_act_rule(
        y.device.type, y.dtype,
        y.is_contiguous() and (residual is None or residual.is_contiguous()),
        any(n.training or n.running_mean is None for n in norms if n is not None),
        torch.is_grad_enabled(), tracing(y))


def tracing(t: torch.Tensor) -> bool:
    """Whether ``t`` flows through a ``torch.compile`` or ``torch.export``
    trace (or a TorchScript one): a compiler or exporter traces with fakes
    or proxies in place of plain tensors, and has no tensor to hand a
    kernel."""
    return (torch.compiler.is_compiling() or torch.jit.is_tracing()
            or type(t) is not torch.Tensor)


def _norm_act(bn: Optional[nn.BatchNorm2d], y: torch.Tensor, f32: bool = True) -> torch.Tensor:
    """``F.relu(_norm(bn, y, f32))``, as one pass of the kernel where the
    rule allows."""
    if _fused(y, bn):
        return fused_bn_act(y, bn)
    out = _norm(bn, y, f32)
    del y  # freed before the ReLU, as when the conv's output was a temporary
    return F.relu(out)


def _check_bn_impl(bn_impl: str) -> bool:
    """Whether ``bn_impl`` normalizes in f32."""
    if bn_impl not in BN_IMPLS:
        raise ValueError(f"bn_impl must be one of {BN_IMPLS}, not {bn_impl!r}")
    return bn_impl == "f32"


class _Block(nn.Module):
    """What both blocks share: the shortcut (a 1x1 conv + BN where the
    stride or the width changes, named ``shortcut`` or torchvision's
    ``downsample``) and the BatchNorm knobs."""

    def __init__(self, in_planes: int, out_planes: int, stride: int, folded: bool,
                 shortcut_name: str, bn_impl: str):
        super().__init__()
        self.bn_f32, self.shortcut_name = _check_bn_impl(bn_impl), shortcut_name
        if stride != 1 or in_planes != out_planes:
            setattr(self, shortcut_name, nn.Sequential(
                nn.Conv2d(in_planes, out_planes, 1, stride, bias=folded),
                *([] if folded else [nn.BatchNorm2d(out_planes)]),
            ))
        else:
            setattr(self, shortcut_name, nn.Sequential())

    def norm(self, bn, x):
        return _norm(bn, x, self.bn_f32)

    def shortcut_parts(self):
        """The shortcut's 1x1 conv and its BatchNorm, each None where the
        block has none (an identity shortcut; a folded model's BatchNorm)."""
        seq = getattr(self, self.shortcut_name)
        if not len(seq):
            return None, None
        return seq[0], seq[1] if len(seq) > 1 else None

    def norm_act(self, bn, y, x=None):
        """``F.relu(bn(y))``, or with the block's input ``x`` ``F.relu(bn(y)
        + shortcut(x))``, as one pass of the kernel where the rule allows."""
        if x is None:
            return _norm_act(bn, y, self.bn_f32)
        conv, shortcut_bn = self.shortcut_parts()
        if _fused(y, bn, shortcut_bn, residual=x):
            return fused_bn_act(y, bn, x if conv is None else _conv(conv, x), shortcut_bn)
        out = self.norm(bn, y)
        del y
        return F.relu(out + (x if conv is None else self.norm(shortcut_bn, _conv(conv, x))))


class BasicBlock(_Block):
    """conv3x3-bn-relu, conv3x3-bn, +shortcut, relu."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1, folded: bool = False,
                 shortcut_name: str = "shortcut", bn_impl: str = "f32"):
        super().__init__(in_planes, planes, stride, folded, shortcut_name, bn_impl)
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=folded)
        self.bn1 = None if folded else nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=folded)
        self.bn2 = None if folded else nn.BatchNorm2d(planes)

    def forward(self, x):
        out = self.norm_act(self.bn1, _conv(self.conv1, x))
        return self.norm_act(self.bn2, _conv(self.conv2, out), x)


class Bottleneck(_Block):
    """1x1 -> 3x3 (stride, ``groups``) -> 1x1 with 4x expansion; the inner
    width is ``int(planes * base_width / 64) * groups`` (torchvision's
    ResNeXt and wide ResNets)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1, folded: bool = False,
                 shortcut_name: str = "shortcut", bn_impl: str = "f32", groups: int = 1,
                 base_width: int = 64):
        out = planes * self.expansion
        super().__init__(in_planes, out, stride, folded, shortcut_name, bn_impl)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2d(in_planes, width, 1, bias=folded)
        self.bn1 = None if folded else nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=folded)
        self.bn2 = None if folded else nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=folded)
        self.bn3 = None if folded else nn.BatchNorm2d(out)

    def forward(self, x):
        out = self.norm_act(self.bn1, _conv(self.conv1, x))
        out = self.norm_act(self.bn2, _conv(self.conv2, out))
        return self.norm_act(self.bn3, _conv(self.conv3, out), x)


class ResNet(nn.Module):
    """ResNet: features + linear head. Takes NCHW input;
    ``forward(x, features_only=True)`` returns the f32 pooled features."""

    def __init__(self, block, num_blocks: Sequence[int], num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, folded: bool = False, groups: int = 1,
                 base_width: int = 64, imagenet_stem: bool = False, bn_impl: str = "f32"):
        super().__init__()
        self.block, self.num_blocks, self.num_classes = block, tuple(num_blocks), num_classes
        self.dtype, self.folded, self.bn_impl = dtype, folded, bn_impl
        self.groups, self.base_width, self.imagenet_stem = groups, base_width, imagenet_stem
        self.bn_f32 = _check_bn_impl(bn_impl)
        # torchvision's key grammar on its ImageNet ResNets, the reference's on the CIFAR ones
        self.head_name = "fc" if imagenet_stem else "linear"
        shortcut_name = "downsample" if imagenet_stem else "shortcut"
        extra = ({"groups": groups, "base_width": base_width}
                 if (groups, base_width) != (1, 64) else {})
        if imagenet_stem:
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=folded)
        else:
            self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=folded)
        self.bn1 = None if folded else nn.BatchNorm2d(64)
        in_planes = 64
        for stage, (planes, blocks, stride) in enumerate(
            zip((64, 128, 256, 512), self.num_blocks, (1, 2, 2, 2)), start=1
        ):
            layers = []
            for s in [stride] + [1] * (blocks - 1):
                layers.append(block(in_planes, planes, s, folded=folded,
                                    shortcut_name=shortcut_name, bn_impl=bn_impl, **extra))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*layers))
        setattr(self, self.head_name, nn.Linear(512 * block.expansion, num_classes))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)

    def forward(self, x, features_only: bool = False):
        out = _norm_act(self.bn1, _conv(self.conv1, x), self.bn_f32)
        if self.imagenet_stem:
            out = F.max_pool2d(out, 3, 2, 1)
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        out = out.mean(dim=(2, 3)).float()  # global average pool
        if features_only:
            return out
        return getattr(self, self.head_name)(out)

    def clone(self, dtype: Optional[torch.dtype] = None, folded: Optional[bool] = None,
              bn_impl: Optional[str] = None) -> "ResNet":
        """A fresh module of the same architecture (block, depth, width,
        groups, stem) with other knobs; the caller loads its weights."""
        return ResNet(
            self.block, self.num_blocks, self.num_classes,
            dtype=self.dtype if dtype is None else dtype,
            folded=self.folded if folded is None else folded,
            groups=self.groups, base_width=self.base_width, imagenet_stem=self.imagenet_stem,
            bn_impl=self.bn_impl if bn_impl is None else bn_impl,
        )


def ResNet10(num_classes: int = 10, dtype=torch.float32) -> ResNet:
    return ResNet(BasicBlock, (1, 1, 1, 1), num_classes, dtype=dtype)


def ResNet18(num_classes: int = 10, dtype=torch.float32) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, dtype=dtype)


def ResNet34(num_classes: int = 10, dtype=torch.float32) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, dtype=dtype)


def ResNet50(num_classes: int = 10, dtype=torch.float32) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, dtype=dtype)


def ResNet101(num_classes: int = 10, dtype=torch.float32) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, dtype=dtype)


def ResNet152(num_classes: int = 10, dtype=torch.float32) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes, dtype=dtype)


# torchvision's ImageNet ResNets (the reference reaches them through its
# torchvision star-import): the ImageNet stem, downsample.N and fc.
def _tv(block, num_blocks, num_classes, dtype, **kw) -> ResNet:
    return ResNet(block, num_blocks, num_classes, dtype=dtype, imagenet_stem=True, **kw)


def resnet18(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return _tv(BasicBlock, (2, 2, 2, 2), num_classes, dtype)


def resnet34(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return _tv(BasicBlock, (3, 4, 6, 3), num_classes, dtype)


def resnet50(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return _tv(Bottleneck, (3, 4, 6, 3), num_classes, dtype)


def resnet101(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return _tv(Bottleneck, (3, 4, 23, 3), num_classes, dtype)


def resnet152(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return _tv(Bottleneck, (3, 8, 36, 3), num_classes, dtype)


def resnext50_32x4d(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return _tv(Bottleneck, (3, 4, 6, 3), num_classes, dtype, groups=32, base_width=4)


def resnext101_32x8d(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return _tv(Bottleneck, (3, 4, 23, 3), num_classes, dtype, groups=32, base_width=8)


def wide_resnet50_2(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return _tv(Bottleneck, (3, 4, 6, 3), num_classes, dtype, base_width=128)


def wide_resnet101_2(num_classes: int = 1000, dtype=torch.float32) -> ResNet:
    return _tv(Bottleneck, (3, 4, 23, 3), num_classes, dtype, base_width=128)
