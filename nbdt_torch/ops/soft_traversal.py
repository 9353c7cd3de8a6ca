"""Fused soft-NBDT head: classifier + node logits + per-node log-softmax +
leaf path sum, as one hand-written CUDA kernel (``csrc/soft_head.cu``).

Counterpart of ``nbdt_tpu/ops/soft_traversal.py``. For each batch row:

    x    = feats @ W + b           [C]     classifier (f32 FMA, or bf16 reads
                                            accumulated in f32)
    nl   = membership-weighted sums of x per child slot      (exact f32)
    logp = exact masked log-softmax over each node's children (exact f32)
    leaf = sum of logp over the slots containing each class  (exact f32)

``leaf`` is the log of the reference's product-of-probabilities leaf
distribution; argmax(leaf) is the NBDT prediction.

The TPU kernel fed dense, lane-padded membership and path matrices to its
matrix unit. Here the tree constants are compact index lists built on the
host (:func:`prepare_head_constants`); the kernel loops over them.

On a CPU tensor :func:`fused_soft_head` computes :func:`soft_head_reference`,
the plain PyTorch version. On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..rules import exact_f32
from ..tree import TreeArrays
from ..utils import resolve_device
from ._build import load_library

NEG = -1e30
BLOCK_B = 16  # batch rows per block (chip_smoke.py times 8-64); shrunk until a tile fits
SMEM_LIMIT = 232448  # dynamic shared memory one Hopper block may use

launches = 0  # kernel launches since the caller last reset it


class HeadConstants(NamedTuple):
    """Device constants of the head. Slots s = n*K + k are node-major."""

    W: torch.Tensor  # [D, C] classifier kernel, f32 or bf16
    b: torch.Tensor  # [C] f32
    slot_ptr: torch.Tensor  # [S+1] int32: slot s owns entries slot_ptr[s]:slot_ptr[s+1]
    slot_cls: torch.Tensor  # [nnz] int32 classes under each slot
    slot_w: torch.Tensor  # [nnz] f32 membership weight of each
    slot_valid: torch.Tensor  # [S] uint8, 1 on real child slots
    class_ptr: torch.Tensor  # [C+1] int32: class c owns class_ptr[c]:class_ptr[c+1]
    class_slot: torch.Tensor  # [nnz] int32 slots containing each class
    num_classes: int
    num_nodes: int
    max_children: int


def _csr(rows: np.ndarray, n: int) -> np.ndarray:
    ptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=ptr[1:])
    return ptr


def prepare_head_constants(
    ta: TreeArrays,
    fc_kernel: np.ndarray,
    fc_bias: Optional[np.ndarray] = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> HeadConstants:
    """Build the head's constants from tree arrays and a classifier kernel
    ``[D, C]``. ``dtype`` applies to W only (bf16 to match a bf16 backbone);
    every tree constant stays f32."""
    device = resolve_device(device)
    N, K, C = ta.membership.shape
    D = fc_kernel.shape[0]
    assert fc_kernel.shape == (D, C), fc_kernel.shape
    S = N * K
    m = ta.membership.reshape(S, C)
    slots, classes = np.nonzero(m)  # row-major: grouped by slot
    u_classes, u_slots = np.nonzero(ta.under.reshape(S, C).T > 0)  # grouped by class
    b = np.zeros(C, np.float32) if fc_bias is None else np.asarray(fc_bias, np.float32)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    return HeadConstants(
        W=put(np.asarray(fc_kernel, np.float32), torch.float32).to(dtype),
        b=put(b, torch.float32),
        slot_ptr=put(_csr(slots, S), torch.int32),
        slot_cls=put(classes, torch.int32),
        slot_w=put(m[slots, classes], torch.float32),
        slot_valid=put(ta.child_mask.reshape(S), torch.uint8),
        class_ptr=put(_csr(u_classes, C), torch.int32),
        class_slot=put(u_slots, torch.int32),
        num_classes=C,
        num_nodes=N,
        max_children=K,
    )


def soft_head_reference(feats: torch.Tensor, hc: HeadConstants, want_aux: bool = True):
    """Plain PyTorch version of the kernel on the same inputs; the classifier
    ``x`` is computed in f32. Returns what :func:`fused_soft_head` returns."""
    N, K, C = hc.num_nodes, hc.max_children, hc.num_classes
    S = N * K
    B = feats.shape[0]
    with exact_f32():
        x = feats.float() @ hc.W.float() + hc.b
    dev = feats.device
    slot_of = torch.repeat_interleave(torch.arange(S, device=dev), hc.slot_ptr.diff().long())
    nl = torch.zeros(B, S, device=dev).index_add_(
        1, slot_of, x[:, hc.slot_cls.long()] * hc.slot_w)
    valid = hc.slot_valid.bool().reshape(N, K)
    nl3 = nl.reshape(B, N, K)
    m = torch.where(valid, nl3, NEG).amax(-1, keepdim=True)
    m = torch.where(m > NEG / 2, m, 0.0)
    e = torch.where(valid, torch.exp(nl3 - m), 0.0).sum(-1, keepdim=True)
    lse = torch.log(e.clamp_min(1e-30)) + m
    logp = torch.where(valid, nl3 - lse, 0.0).reshape(B, S)
    class_of = torch.repeat_interleave(torch.arange(C, device=dev), hc.class_ptr.diff().long())
    leaf = torch.zeros(B, C, device=dev).index_add_(1, class_of, logp[:, hc.class_slot.long()])
    if not want_aux:
        return (leaf,)
    return leaf, x, torch.where(valid.reshape(S), logp, NEG)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (pointers and the
    stream as c_void_p, so ctypes does not cut them to 32 bits)."""
    lib = load_library("soft_head")
    lib.nbdt_soft_head_smem_bytes.restype = ctypes.c_size_t
    lib.nbdt_soft_head_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.nbdt_soft_head.restype = ctypes.c_int
    lib.nbdt_soft_head.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.nbdt_cuda_error_string.restype = ctypes.c_char_p
    lib.nbdt_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _pick_block_b(lib, block_b: int, D: int, C: int, S: int) -> int:
    tb = max(1, block_b)
    while tb > 1 and lib.nbdt_soft_head_smem_bytes(tb, D, C, S) > SMEM_LIMIT:
        tb //= 2
    if lib.nbdt_soft_head_smem_bytes(tb, D, C, S) > SMEM_LIMIT:
        raise ValueError(
            f"soft_head: one row's tile (D={D}, C={C}, N*K={S}) exceeds "
            f"{SMEM_LIMIT} bytes of shared memory"
        )
    return tb


def fused_soft_head(
    feats: torch.Tensor,
    hc: HeadConstants,
    block_b: int = BLOCK_B,
    want_aux: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Run the fused head: feats [B, D] -> (leaf_logp [B, C][, logits [B, C],
    node_logp [B, N*K]]), node_logp node-major with padded slots = -1e30.
    ``want_aux=False`` returns only the leaf log-probs and writes nothing
    else. feats is cast to W's dtype, as in the JAX package."""
    global launches
    if feats.device != hc.W.device:
        raise ValueError(f"feats on {feats.device} but head constants on {hc.W.device}")
    if feats.dim() != 2 or feats.shape[1] != hc.W.shape[0]:
        raise ValueError(f"feats must be [B, {hc.W.shape[0]}], got {tuple(feats.shape)}")
    feats = feats.to(hc.W.dtype)
    if feats.device.type == "cpu":
        return soft_head_reference(feats, hc, want_aux)
    if feats.device.type != "cuda":
        raise ValueError(f"soft_head runs on CUDA or CPU tensors, not {feats.device}")
    if hc.W.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"soft_head takes f32 or bf16 W, not {hc.W.dtype}")
    if not feats.is_contiguous():
        raise ValueError("soft_head needs contiguous feats")

    lib = _library()
    B, D = feats.shape
    N, K, C = hc.num_nodes, hc.max_children, hc.num_classes
    S = N * K
    tb = _pick_block_b(lib, block_b, D, C, S)
    leaf = torch.empty(B, C, device=feats.device, dtype=torch.float32)
    logits = logp = None
    if want_aux:
        logits = torch.empty(B, C, device=feats.device, dtype=torch.float32)
        logp = torch.empty(B, S, device=feats.device, dtype=torch.float32)
    if B == 0:
        return (leaf, logits, logp) if want_aux else (leaf,)

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    stream = torch.cuda.current_stream(feats.device)
    err = lib.nbdt_soft_head(
        ptr(feats), ptr(hc.W), ptr(hc.b), ptr(hc.slot_ptr), ptr(hc.slot_cls),
        ptr(hc.slot_w), ptr(hc.slot_valid), ptr(hc.class_ptr), ptr(hc.class_slot),
        ptr(leaf), ptr(logits), ptr(logp),
        B, D, C, N, K, tb, int(hc.W.dtype == torch.bfloat16), feats.device.index or 0,
        ctypes.c_void_p(stream.cuda_stream),
    )
    if err != 0:
        raise RuntimeError(
            f"soft_head launch failed: {lib.nbdt_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return (leaf, logits, logp) if want_aux else (leaf,)


def make_fused_soft_head(ta: TreeArrays, fc_kernel, fc_bias=None,
                         block_b: int = BLOCK_B, device="cuda"):
    """Returns ``feats -> (leaf_logp, logits)`` over constants built once."""
    hc = prepare_head_constants(ta, np.asarray(fc_kernel), fc_bias, device=device)

    def head(feats):
        leaf, logits, _ = fused_soft_head(feats, hc, block_b=block_b)
        return leaf, logits

    return head
