"""3x3 stride-1 SAME convolution, 64 -> 64 channels, + bias + ReLU, bf16 in
and out, as one hand-written CUDA kernel (``csrc/conv3x3.cu``).

Counterpart of the three TPU kernels of ``tools/probe_pallas_conv.py``
(``make_kernel_a``, ``make_kernel_b``, ``make_kernel_c``): one function in
three Mosaic layouts, here one kernel. Layouts are the JAX ones: x and the
result NHWC, the weight HWIO ``[3, 3, 64, 64]``. Products of bf16 values are
summed in f32, the f32 bias is added, then ReLU and one rounding to bf16.
Any N, H and W; the channels are 64 in and out, as in the TPU kernels.
There is no backward (the TPU kernels have no VJP): the wrapper refuses
inputs that would need one.

On a CPU tensor :func:`conv3x3_bias_relu` computes
:func:`conv3x3_bias_relu_reference`, the plain PyTorch version. On a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import aligned, load_library

C = 64  # input and output channels
launches = 0  # kernel launches since the caller last reset it


def conv3x3_bias_relu_reference(x: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the 9-tap shift-and-matmul in
    f32 on the bf16 values (w rounded to bf16 as the wrapper rounds it;
    zero-pad, nine shifted ``[NHW, 64] @ [64, 64]`` products summed, ``+ b``,
    ReLU, one cast to bf16). On CUDA the products are full f32 only with TF32
    off for matmuls (PyTorch's default)."""
    N, H, W, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.to(torch.bfloat16).float()
    acc = torch.zeros(N * H * W, C, dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc.addmm_(xp[:, dy:dy + H, dx:dx + W].reshape(-1, C), wf[dy, dx])
    del xp
    return acc.add_(b.float()).relu_().to(torch.bfloat16).reshape(N, H, W, C)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library with its C signature declared (pointers and the
    stream as c_void_p, so ctypes does not cut them to 32 bits)."""
    lib = load_library("conv3x3")
    lib.nbdt_conv3x3.restype = ctypes.c_int
    lib.nbdt_conv3x3.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.nbdt_conv3x3_error_string.restype = ctypes.c_char_p
    lib.nbdt_conv3x3_error_string.argtypes = [ctypes.c_int]
    return lib


def conv3x3_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``relu(conv3x3(x, w) + b)`` in bf16: x ``[N, H, W, 64]`` bf16 (NHWC),
    w ``[3, 3, 64, 64]`` (HWIO, cast to bf16), b ``[64]`` (cast to f32);
    zero padding, f32 sums."""
    global launches
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv3x3: x must be bf16, not {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != C:
        raise ValueError(f"conv3x3: x must be [N, H, W, {C}] (NHWC), got {tuple(x.shape)}")
    if w.shape != (3, 3, C, C):
        raise ValueError(f"conv3x3: w must be [3, 3, {C}, {C}] (HWIO), got {tuple(w.shape)}")
    if b.shape != (C,):
        raise ValueError(f"conv3x3: b must be [{C}], got {tuple(b.shape)}")
    if not (x.device == w.device == b.device):
        raise ValueError(f"conv3x3: x on {x.device}, w on {w.device}, b on {b.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        raise RuntimeError("conv3x3 is forward only (no backward); call it under "
                           "torch.no_grad()")
    if w.dtype != torch.bfloat16:
        w = w.to(torch.bfloat16)
    if b.dtype != torch.float32:
        b = b.float()
    if x.device.type == "cpu":
        return conv3x3_bias_relu_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 runs on CUDA or CPU tensors, not {x.device}")

    lib = _library()
    x, w, b = aligned(x), w.contiguous(), b.contiguous()
    y = torch.empty_like(x)
    N, H, W, _ = x.shape
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device)
    err = lib.nbdt_conv3x3(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(b.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        N, H, W, x.device.index or 0, ctypes.c_void_p(stream.cuda_stream),
    )
    if err != 0:
        raise RuntimeError(
            f"conv3x3 launch failed: {lib.nbdt_conv3x3_error_string(err).decode()} ({err})")
    launches += 1
    return y
