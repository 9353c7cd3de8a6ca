"""Eval-mode BatchNorm, an optional residual (with its own BatchNorm or
without) and a ReLU as one hand-written CUDA pass over a convolution's
output, written in place (``csrc/bn_act.cu``).

It replaces no TPU kernel: the JAX package leaves these steps to XLA, which
fuses them, while in PyTorch eager they are three library passes (cuDNN's
inference BatchNorm, the add, the ReLU), each reading and writing the whole
conv output. The pass is bound by bytes: it reads the output (and the
residual) once and writes it once. ``models/resnet.py`` calls it where its
rule allows (CUDA, f32, contiguous NCHW, eval statistics, no autograd, no
trace).

Per channel ``c``: ``s = weight / sqrt(running_var + eps)``, read from the
``nn.BatchNorm2d`` on every call, and ``y = relu((x - running_mean) * s +
bias + r')`` with ``r'`` absent, the residual, or the residual through its
own BatchNorm. The mean is subtracted before the scale: folded into a shift
(``x * s + bias - running_mean * s``) it cancels digits where a channel's
mean is large against its spread. :func:`bn_act_reference` computes that
in plain PyTorch; the kernel rounds at the same places and equals it bit for
bit. On a CPU tensor :func:`fused_bn_act` computes the plain version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ._build import load_library

launches = 0  # kernel launches since the caller last reset it


def _normalize(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    def per_channel(v):
        return v.view(1, -1, 1, 1)

    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return (x - per_channel(bn.running_mean)) * per_channel(s) + per_channel(bn.bias)


def bn_act_reference(x: torch.Tensor, bn: nn.BatchNorm2d,
                     residual: Optional[torch.Tensor] = None,
                     residual_bn: Optional[nn.BatchNorm2d] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, as a new tensor."""
    y = _normalize(x, bn)
    if residual is not None:
        y = y + (residual if residual_bn is None else _normalize(residual, residual_bn))
    return F.relu(y)


def _check(x: torch.Tensor, bn: nn.BatchNorm2d, residual, residual_bn) -> None:
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"bn_act takes a contiguous NCHW f32 x, not {x.dtype} "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    norms = [bn] + ([residual_bn] if residual_bn is not None else [])
    for norm in norms:
        tensors = (norm.weight, norm.bias, norm.running_mean, norm.running_var)
        if any(t is None for t in tensors):
            raise ValueError("bn_act needs an affine BatchNorm with running statistics")
        if any(t.shape != (x.shape[1],) or t.dtype != torch.float32 or t.device != x.device
               for t in tensors):
            raise ValueError(f"bn_act: a BatchNorm's tensors must be f32 [{x.shape[1]}] on "
                             f"{x.device}")
    if residual_bn is not None and residual is None:
        raise ValueError("bn_act: residual_bn without a residual")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError(f"bn_act: the residual must be contiguous f32 {tuple(x.shape)} on "
                         f"{x.device}")
    if any(t.data_ptr() % 16 for t in (x, residual) if t is not None):
        raise ValueError("bn_act: x and the residual must start on a 16-byte boundary (the "
                         "caching allocator's tensors do; an offset view does not)")
    grads = [x] + ([residual] if residual is not None else []) + [
        p for norm in norms for p in (norm.weight, norm.bias)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in grads):
        raise RuntimeError("bn_act is forward only (no backward); call it under "
                           "torch.no_grad()")


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library with its C signature declared (pointers and the
    stream as c_void_p, so ctypes does not cut them to 32 bits)."""
    lib = load_library("bn_act")
    lib.nbdt_bn_act.restype = ctypes.c_int
    lib.nbdt_bn_act.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_void_p] * 4 + [ctypes.c_float]
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.nbdt_bn_act_error_string.restype = ctypes.c_char_p
    lib.nbdt_bn_act_error_string.argtypes = [ctypes.c_int]
    return lib


def _pointers(bn: Optional[nn.BatchNorm2d]):
    if bn is None:
        return [None] * 4 + [0.0]
    return [ctypes.c_void_p(t.data_ptr())
            for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var)] + [bn.eps]


def fused_bn_act(x: torch.Tensor, bn: nn.BatchNorm2d, residual: Optional[torch.Tensor] = None,
                 residual_bn: Optional[nn.BatchNorm2d] = None) -> torch.Tensor:
    """``relu(bn(x) [+ residual_bn(residual)])`` of a contiguous NCHW f32
    ``x`` with ``bn``'s running statistics (``residual_bn`` only with a
    ``residual``), written over ``x``, which is returned."""
    global launches
    _check(x, bn, residual, residual_bn)
    if x.device.type == "cpu":
        return x.copy_(bn_act_reference(x, bn, residual, residual_bn))
    if x.device.type != "cuda":
        raise ValueError(f"bn_act runs on CUDA or CPU tensors, not {x.device}")
    N, C, H, W = x.shape
    if x.numel() == 0:
        return x
    if H * W >= 2 ** 30 or x.numel() // 1024 >= 2 ** 31:
        raise ValueError(f"bn_act: {tuple(x.shape)} is beyond the kernel's index range")

    lib = _library()
    mode = 0 if residual is None else 1 if residual_bn is None else 2
    stream = torch.cuda.current_stream(x.device)
    err = lib.nbdt_bn_act(
        ctypes.c_void_p(x.data_ptr()),
        ctypes.c_void_p(residual.data_ptr() if residual is not None else None),
        *_pointers(bn), *_pointers(residual_bn), x.numel(), H * W, C, mode,
        x.device.index or 0, ctypes.c_void_p(stream.cuda_stream),
    )
    if err != 0:
        raise RuntimeError(
            f"bn_act launch failed: {lib.nbdt_bn_act_error_string(err).decode()} ({err})")
    launches += 1
    return x
