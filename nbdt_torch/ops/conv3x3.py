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

The launch is laid out on the host by :func:`plan_conv3x3` (bands, column
tiles, window pitch, ring stages, grid and shared memory), and the weight is
packed to the kernel's ``[co, tap*64 + ci]`` by :func:`pack_weight`; both are
plain Python, so the CPU tests reach them.

On a CPU tensor :func:`conv3x3_bias_relu` computes
:func:`conv3x3_bias_relu_reference`, the plain PyTorch version. On a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import aligned, load_library

C = 64  # input and output channels
TAPS = 9
TILE_W = 32  # output columns of a tile
BAND = 4  # output rows of a tile
PITCH = TILE_W + 2  # window pixels a row, halo included; wgmma N = BAND x PITCH = 136
CONSUMERS = 2  # consumer warpgroups a block, on alternate tiles
PIX_BYTES = 2 * C  # one pixel of 64 bf16 channels, one 128-byte swizzle row
W_BYTES = TAPS * C * C * 2  # the packed weight, resident in shared memory
OUT_STAGE = (BAND * TILE_W + 8) * PIX_BYTES  # a warpgroup's output stage + 8 pad rows
ALIGN = 1024  # the 128-byte swizzle repeats every 1 KB
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100
MAX_STAGES = 4
launches = 0  # kernel launches since the caller last reset it
last_plan = None  # the plan of the last launch


class Conv3x3Plan(NamedTuple):
    """How one call of the kernel is laid out (see ``csrc/conv3x3.cu``)."""

    band_rows: int  # output rows of a tile
    col_tiles: int  # tiles of TILE_W output columns across a row
    pitch: int  # window pixels a row (the TMA box's width)
    stages: int  # window stages in the ring
    tiles: int  # N x row bands x col_tiles
    grid: int  # persistent blocks, at most one an SM
    smem_bytes: int  # dynamic shared memory of one block


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


def smem_bytes(stages: int) -> int:
    """Dynamic shared memory of one block: alignment slack, the weight, the
    window ring (each stage rounded up to 1 KB), two output stages and the
    mbarriers (the layout of ``conv3x3_kernel``)."""
    window = _cdiv((BAND + 2) * PITCH * PIX_BYTES, ALIGN) * ALIGN
    return ALIGN + W_BYTES + stages * window + CONSUMERS * OUT_STAGE + 8 * (1 + 2 * stages)


def plan_conv3x3(N: int, H: int, W: int, sms: int, smem_limit: int = SMEM_LIMIT) -> Conv3x3Plan:
    """The launch at one shape. Pure host code. Tiles are one image, BAND
    output rows and TILE_W columns; the ring takes the most window stages
    (up to MAX_STAGES) that fit ``smem_limit``; the grid is one block an SM,
    or one a tile when there are fewer tiles. Raises ``ValueError`` when two
    stages do not fit or the shape is empty."""
    if min(N, H, W) < 1 or sms < 1:
        raise ValueError(f"conv3x3: no launch for N={N}, H={H}, W={W} on {sms} SMs")
    stages = max((s for s in range(2, MAX_STAGES + 1) if smem_bytes(s) <= smem_limit),
                 default=0)
    if not stages:
        raise ValueError(f"conv3x3: two window stages need {smem_bytes(2)} bytes of shared "
                         f"memory, over {smem_limit}")
    col_tiles = _cdiv(W, TILE_W)
    tiles = N * _cdiv(H, BAND) * col_tiles
    return Conv3x3Plan(BAND, col_tiles, PITCH, stages, tiles, min(sms, tiles), smem_bytes(stages))


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, 64, 64]`` -> the kernel's ``[co, tap*64 + ci]`` (tap =
    dy*3 + dx), contiguous, in w's dtype."""
    return w.permute(3, 0, 1, 2).reshape(C, TAPS * C).contiguous()


@functools.lru_cache(maxsize=8)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
    lib.nbdt_conv3x3_smem_bytes.restype = ctypes.c_int
    lib.nbdt_conv3x3_smem_bytes.argtypes = [ctypes.c_int]
    lib.nbdt_conv3x3.restype = ctypes.c_int
    lib.nbdt_conv3x3.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.nbdt_conv3x3_error_string.restype = ctypes.c_char_p
    lib.nbdt_conv3x3_error_string.argtypes = [ctypes.c_int]
    return lib


def conv3x3_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``relu(conv3x3(x, w) + b)`` in bf16: x ``[N, H, W, 64]`` bf16 (NHWC),
    w ``[3, 3, 64, 64]`` (HWIO, cast to bf16), b ``[64]`` (cast to f32);
    zero padding, f32 sums."""
    global launches, last_plan
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
    x, b = aligned(x), b.contiguous()
    wpk = aligned(pack_weight(w))
    y = torch.empty_like(x)
    N, H, W, _ = x.shape
    if y.numel() == 0:
        return y
    device = x.device.index or 0
    plan = plan_conv3x3(N, H, W, _sm_count(device))
    stream = torch.cuda.current_stream(x.device)
    err = lib.nbdt_conv3x3(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(wpk.data_ptr()),
        ctypes.c_void_p(b.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        N, H, W, plan.stages, plan.grid, plan.smem_bytes, device,
        ctypes.c_void_p(stream.cuda_stream),
    )
    if err != 0:
        raise RuntimeError(
            f"conv3x3 launch failed ({plan}): "
            f"{lib.nbdt_conv3x3_error_string(err).decode()} ({err})")
    launches += 1
    last_plan = plan
    return y
