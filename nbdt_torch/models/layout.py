"""The memory layout in which the inference entries place a backbone.

:func:`conv_memory_format` is the rule and :func:`place_backbone` applies
it to a module at the moment it is placed; each entry then hands the
backbone its NHWC input as ``x.permute(0, 3, 1, 2).contiguous(
memory_format=fmt)``, a channels-last view or one contiguous copy. The
training sites (``Trainer``, ``examples/train_seg.py`` and
``init_model``, whose module ``examples/train_imagenet.py`` trains) keep
channels-last until the trainer places the model itself.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

NCHW = torch.contiguous_format


def conv_memory_format(device_type: str, dtype: Optional[torch.dtype],
                       allow_tf32: bool) -> torch.memory_format:
    """The memory format for a backbone whose convolutions hold ``dtype``
    weights on a ``device_type`` device, with cuDNN's TF32 switch at
    ``allow_tf32``.

    Contiguous NCHW for f32 on CUDA with TF32 off: cuDNN then has no
    tensor-core engine, and its f32 engines (implicit GEMM, FFT) are NCHW
    kernels, so channels-last tensors cost a transpose of every conv's
    input to NCHW and of its output back. Channels-last otherwise: bf16 and
    f16 (and f32 with TF32 allowed, PyTorch's default) run NHWC tensor-core
    kernels, and the CPU keeps the layout, and the rounding, it always had.
    A ``dtype`` of None (a backbone without a conv) keeps channels-last.

    What NCHW costs in turn (H100, f32): cuDNN's inference BatchNorm is
    slower on NCHW planes of a few pixels than on NHWC; depthwise convs go
    to ATen's ``conv_depthwise2d``, 1.3-2.9x cuDNN's NHWC kernels, so a net
    of pointwise and depthwise convs gains or loses by the ratio of the
    two (ShuffleNetV2 -17%, MNASNet +9%); and at small batches cuDNN's
    heuristics may pick a slower NCHW engine (a CIFAR ResNet18 request of
    64 images takes 64x64 FFTs, 1.4x the channels-last time; at 32 and
    from 128 images up NCHW is faster)."""
    nchw = device_type == "cuda" and dtype == torch.float32 and not allow_tf32
    return NCHW if nchw else torch.channels_last


def place_backbone(model: nn.Module, device) -> Tuple[nn.Module, torch.memory_format]:
    """``model`` in eval mode on ``device``, its 4-d weights in the format
    :func:`conv_memory_format` gives for its first ``nn.Conv2d``; returns
    the module and that format. The TF32 switch is read here, once: turn
    it off before the wrapper that calls this is built, or the backbone
    stays channels-last. The module is moved in place, so wrappers built
    on one module share the layout of the last one placed."""
    device = torch.device(device)
    dtype = next((m.weight.dtype for m in model.modules() if isinstance(m, nn.Conv2d)), None)
    fmt = conv_memory_format(device.type, dtype, torch.backends.cudnn.allow_tf32)
    return model.to(device, memory_format=fmt).eval(), fmt
