"""Fused LayerNorm over the last axis, forward only, as one hand-written
CUDA kernel (``csrc/layernorm.cu``).

Counterpart of ``nbdt_tpu/ops/layernorm.py``: mean and the variance of the
centred values in f32 whatever the input dtype, ``rsqrt(var + eps)``, the f32
affine, and the result cast back to the input dtype. The feature width must
be a multiple of 128, as the JAX kernel asserts. There is no backward (the
JAX kernel has no VJP): the wrapper refuses inputs that would need one.

On a CPU tensor :func:`fused_layernorm` computes :func:`layernorm_reference`,
the plain PyTorch version. On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import aligned, load_library

launches = 0  # kernel launches since the caller last reset it


def layernorm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the JAX kernel's formula on
    tensors."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(-1, keepdim=True)
    out = centered * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library with its C signature declared (pointers and the
    stream as c_void_p, so ctypes does not cut them to 32 bits)."""
    lib = load_library("layernorm")
    lib.nbdt_layernorm.restype = ctypes.c_int
    lib.nbdt_layernorm.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.nbdt_layernorm_error_string.restype = ctypes.c_char_p
    lib.nbdt_layernorm_error_string.argtypes = [ctypes.c_int]
    return lib


def fused_layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm of ``x [..., D]`` over its last axis with f32 ``weight`` and
    ``bias`` ``[D]``; stats in f32, output in ``x.dtype``."""
    global launches
    D = x.shape[-1]
    if D % 128 != 0:
        raise ValueError(f"layernorm: feature dim {D} must be a multiple of 128")
    if weight.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"layernorm: weight and bias must be [{D}], got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("layernorm is forward only (no backward); call it under "
                           "torch.no_grad()")
    if not (x.device == weight.device == bias.device):
        raise ValueError(f"layernorm: x on {x.device}, weight on {weight.device}, "
                         f"bias on {bias.device}")
    if x.device.type == "cpu":
        return layernorm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"layernorm takes f32 or bf16 x, not {x.dtype}")

    lib = _library()
    x = aligned(x)
    weight, bias = aligned(weight.float()), aligned(bias.float())
    y = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return y
    stream = torch.cuda.current_stream(x.device)
    err = lib.nbdt_layernorm(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(weight.data_ptr()),
        ctypes.c_void_p(bias.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        rows, D, eps, int(x.dtype == torch.bfloat16), x.device.index or 0,
        ctypes.c_void_p(stream.cuda_stream),
    )
    if err != 0:
        raise RuntimeError(
            f"layernorm launch failed: {lib.nbdt_layernorm_error_string(err).decode()} ({err})")
    launches += 1
    return y
