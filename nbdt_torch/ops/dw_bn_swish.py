"""A depthwise k x k convolution with its zero padding, eval-mode BatchNorm
and swish as one hand-written CUDA pass (``csrc/dw_bn_swish.cu``), for
EfficientNet's depthwise ConvBlocks.

It replaces no TPU kernel: the JAX package leaves the depthwise conv,
BatchNorm and swish to XLA, which fuses the epilogue into the conv, while in
PyTorch eager they are up to four library passes (``F.pad``'s copy before a
stride-2 TF "SAME" conv, ATen's NCHW ``conv_depthwise2d``, cuDNN's inference
BatchNorm, the swish), each reading and writing a whole tensor. The pass is
bound by bytes: it reads the unpadded input once, loads the pad as zeros,
and writes the activated output once. ``models/efficientnet.py`` calls it
where its rule allows (a depthwise conv of 3x3 or 5x5 at stride 1 or 2 with
swish, on CUDA, f32, contiguous NCHW, eval statistics, no autograd, no
trace).

``pads`` are ``F.pad``'s ``(left, right, top, bottom)``. Per channel ``c``,
``s = weight / sqrt(running_var + eps)`` from the ``nn.BatchNorm2d`` on every
call, and ``silu((conv - running_mean) * s + bias)``, the BatchNorm as
``ops/bn_act.py`` takes it. :func:`dw_bn_swish_reference` computes that in
plain PyTorch; the kernel sums each output's k^2 products in another order
than ``F.conv2d``, so the two agree to the rounding of that sum. On a CPU
tensor :func:`fused_dw_bn_swish` computes the plain version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ._build import load_library
from .bn_act import _normalize

KERNELS = (3, 5)
STRIDES = (1, 2)

launches = 0  # kernel launches since the caller last reset it


def out_size(n: int, kernel: int, stride: int, before: int, after: int) -> int:
    """Outputs of a side of ``n`` inputs, padded, at ``stride``."""
    return (n + before + after - kernel) // stride + 1


def dw_bn_swish_reference(x: torch.Tensor, weight: torch.Tensor, bn: nn.BatchNorm2d,
                          stride: int, pads: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel, as a new tensor."""
    padded = F.pad(x, list(pads)) if any(pads) else x
    y = F.conv2d(padded, weight, stride=stride, groups=x.shape[1])
    return F.silu(_normalize(y, bn))


def _check(x: torch.Tensor, weight: torch.Tensor, bn: nn.BatchNorm2d, stride: int,
           pads: Sequence[int]) -> None:
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"dw_bn_swish takes a contiguous NCHW f32 x, not {x.dtype} "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    N, C, H, W = x.shape
    k = weight.shape[-1] if weight.dim() == 4 else None
    if (weight.shape != (C, 1, k, k) or k not in KERNELS or weight.dtype != torch.float32
            or weight.device != x.device or not weight.is_contiguous()):
        raise ValueError(f"dw_bn_swish takes a depthwise f32 weight [{C}, 1, k, k] with k in "
                         f"{KERNELS} on {x.device}, not {weight.dtype} {tuple(weight.shape)}")
    if stride not in STRIDES:
        raise ValueError(f"dw_bn_swish: stride must be one of {STRIDES}, not {stride}")
    if len(pads) != 4 or any(p < 0 or p >= k for p in pads):
        raise ValueError(f"dw_bn_swish: pads (left, right, top, bottom) must lie in [0, {k}), "
                         f"not {tuple(pads)}")
    if min(out_size(H, k, stride, *pads[2:]), out_size(W, k, stride, *pads[:2])) < 1:
        raise ValueError(f"dw_bn_swish: {H}x{W} padded by {tuple(pads)} is smaller than {k}")
    tensors = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    if any(t is None for t in tensors):
        raise ValueError("dw_bn_swish needs an affine BatchNorm with running statistics")
    if bn.training:
        raise ValueError("dw_bn_swish normalizes with running statistics: the BatchNorm is in "
                         "training mode (batch statistics)")
    if any(t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device
           for t in tensors):
        raise ValueError(f"dw_bn_swish: the BatchNorm's tensors must be f32 [{C}] on {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bn.weight, bn.bias)):
        raise RuntimeError("dw_bn_swish is forward only (no backward); call it under "
                           "torch.no_grad()")


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library with its C signature declared (pointers and the
    stream as c_void_p, so ctypes does not cut them to 32 bits)."""
    lib = load_library("dw_bn_swish")
    lib.nbdt_dw_bn_swish.restype = ctypes.c_int
    lib.nbdt_dw_bn_swish.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_void_p] + [ctypes.c_int] * 11
        + [ctypes.c_void_p])
    lib.nbdt_dw_bn_swish_error_string.restype = ctypes.c_char_p
    lib.nbdt_dw_bn_swish_error_string.argtypes = [ctypes.c_int]
    return lib


def fused_dw_bn_swish(x: torch.Tensor, weight: torch.Tensor, bn: nn.BatchNorm2d, stride: int,
                      pads: Sequence[int]) -> torch.Tensor:
    """``silu(bn(conv2d(F.pad(x, pads), weight, stride, groups=C)))`` of a
    contiguous NCHW f32 ``x`` with ``bn``'s running statistics, as a new
    contiguous NCHW f32 tensor."""
    global launches
    _check(x, weight, bn, stride, pads)
    if x.device.type == "cpu":
        return dw_bn_swish_reference(x, weight, bn, stride, pads)
    if x.device.type != "cuda":
        raise ValueError(f"dw_bn_swish runs on CUDA or CPU tensors, not {x.device}")
    N, C, H, W = x.shape
    k = weight.shape[-1]
    left, right, top, bottom = pads
    Ho, Wo = out_size(H, k, stride, top, bottom), out_size(W, k, stride, left, right)
    y = torch.empty((N, C, Ho, Wo), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if H * W >= 2 ** 31 or Ho * Wo >= 2 ** 31 or N * C >= 2 ** 31:
        raise ValueError(f"dw_bn_swish: {tuple(x.shape)} is beyond the kernel's index range")

    lib = _library()
    stream = torch.cuda.current_stream(x.device)
    err = lib.nbdt_dw_bn_swish(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(weight.data_ptr()),
        *(ctypes.c_void_p(t.data_ptr())
          for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var)),
        bn.eps, ctypes.c_void_p(y.data_ptr()), N, C, H, W, Ho, Wo, k, stride, top, left,
        x.device.index or 0, ctypes.c_void_p(stream.cuda_stream),
    )
    if err != 0:  # "invalid argument" also where rows are too wide for shared memory
        raise RuntimeError(
            f"dw_bn_swish launch failed: {lib.nbdt_dw_bn_swish_error_string(err).decode()} "
            f"({err})")
    launches += 1
    return y
