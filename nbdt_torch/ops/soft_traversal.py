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
host (:func:`prepare_head_constants`); the kernel loops over them. The
kernel has two instances, and :func:`plan_soft_head` picks one by shape:
a streaming instance for narrow trees (C <= 32: W and the lists in shared
memory, one warp per group of rows) and a thread-block-cluster instance for
wide ones (Q <= 8 blocks share a tile of rows; each computes the logits of
a slice of the classes, then takes every Q-th row of the tile through the
whole tree).

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
from ._build import aligned, load_library

NEG = -1e30
BLOCK_B = 20  # most batch rows of a cluster tile (the kernel holds up to 20)
SMEM_LIMIT = 232448 - 2048  # dynamic shared memory a Hopper block may use beside static arrays
STREAM_WIDTHS = ((8, 4), (16, 2), (32, 1))  # streaming instance: (padded C, rows per warp step)
MAX_RANKS = 8  # blocks of a cluster (the portable maximum)
CLASS_SLICE = 128  # classes of one classifier pass in a cluster block
W_CHUNK = 64  # W rows of one ring stage in a cluster block
W_STAGES = 4  # W ring stages of a cluster block: three chunks in flight while one is used
TILE_ROWS = 20  # rows a cluster block has room for
F_STRIDE = 24  # floats of one staged feats column in a cluster block
FEAT_BYTES = 2 * 4 * W_CHUNK * F_STRIDE  # a cluster block's two transposed f32 feats chunks
WARPS = 8  # warps of a block, both instances

launches = 0  # kernel launches since the caller last reset it
last_launch: dict = {}  # the plan and grid of the latest launch (for reports)


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


def soft_head_reference(feats: torch.Tensor, hc: HeadConstants, want_aux: bool = True,
                        dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of the kernel on the same inputs; the classifier
    ``x`` and the tree math are computed in ``dtype`` (f32, the kernel's; f64
    gives an exact yardstick for both). Returns what :func:`fused_soft_head`
    returns, in ``dtype``."""
    N, K, C = hc.num_nodes, hc.max_children, hc.num_classes
    S = N * K
    B = feats.shape[0]
    with exact_f32():
        x = feats.to(dtype) @ hc.W.to(dtype) + hc.b.to(dtype)
    dev = feats.device
    slot_of = torch.repeat_interleave(torch.arange(S, device=dev), hc.slot_ptr.diff().long())
    nl = torch.zeros(B, S, device=dev, dtype=dtype).index_add_(
        1, slot_of, x[:, hc.slot_cls.long()] * hc.slot_w.to(dtype))
    valid = hc.slot_valid.bool().reshape(N, K)
    nl3 = nl.reshape(B, N, K)
    m = torch.where(valid, nl3, NEG).amax(-1, keepdim=True)
    m = torch.where(m > NEG / 2, m, 0.0)
    e = torch.where(valid, torch.exp(nl3 - m), 0.0).sum(-1, keepdim=True)
    lse = torch.log(e.clamp_min(1e-30)) + m
    logp = torch.where(valid, nl3 - lse, 0.0).reshape(B, S)
    class_of = torch.repeat_interleave(torch.arange(C, device=dev), hc.class_ptr.diff().long())
    leaf = torch.zeros(B, C, device=dev, dtype=dtype).index_add_(
        1, class_of, logp[:, hc.class_slot.long()])
    if not want_aux:
        return (leaf,)
    return leaf, x, torch.where(valid.reshape(S), logp, NEG)


class HeadPlan(NamedTuple):
    """How one call of the kernel is laid out (see ``csrc/soft_head.cu``)."""

    instance: str  # "stream" (narrow trees) or "cluster" (wide trees)
    rows: int  # batch rows of a warp step (stream) or of a tile (cluster, <= 20)
    q: int  # blocks of a cluster (1 for the streaming instance)
    class_slice: int  # classes of each rank's classifier slice (cluster: a multiple of 128)
    smem_bytes: int  # dynamic shared memory of one block
    blocks: int  # cluster: tiles x q; stream: the blocks the rows could fill
    #              (the launch caps it at two blocks an SM)
    lists_in_smem: bool = True  # the tree lists are staged in shared memory
    stages: int = 0  # W ring stages (cluster)


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


def _round_up(n: int, m: int) -> int:
    return _cdiv(n, m) * m


def stream_smem_bytes(D: int, C: int, S: int, nnz_s: int, nnz_c: int, wbytes: int,
                      rows: int) -> int:
    """Shared memory of a streaming block: W^T (rows padded by 16 bytes),
    bias and lists, per-warp x and slot rows (the layout of
    ``stream_smem`` in the kernel source)."""
    n = C * (D * wbytes + 16)
    n += 4 * (C + nnz_s + WARPS * rows * (C + S))
    n += 4 * (S + 1 + nnz_s + C + 1 + nnz_c)
    return _round_up(n + S, 16)


def cluster_smem_bytes(D: int, C: int, S: int, nnz_s: int, nnz_c: int, wbytes: int, q: int,
                       class_slice: int, stages: int, lists: bool) -> int:
    """Shared memory of a cluster block: two transposed feats chunks and the
    W ring (the feats arrive in the W ring's 64-column chunks, so D does not
    enter), later this rank's rows of x and of the slot log-probs and, with
    ``lists``, the tree lists; then the rank's x for every rank to pull
    (``cluster_smem`` in the kernel source)."""
    groups = _cdiv(_cdiv(TILE_ROWS, q), 4)
    red = 4 * WARPS * TILE_ROWS * CLASS_SLICE  # the warps' partial sums of a pass
    stage = FEAT_BYTES + max(stages * W_CHUNK * CLASS_SLICE * wbytes, red)
    tree = 16 * (groups * _round_up(C, 4) + S)
    if lists:
        tree += (_round_up(4 * (S + 1), 16) + 2 * _round_up(4 * nnz_s, 16)
                 + _round_up(4 * (C + 1), 16) + _round_up(4 * nnz_c, 16) + _round_up(S, 16))
    return _round_up(max(stage, tree), 16) + 16 * q * groups * class_slice


def plan_soft_head(B: int, D: int, C: int, N: int, K: int, dtype: torch.dtype,
                   nnz_slot: int, nnz_class: int,
                   block_b: int = BLOCK_B, clusters: Optional[int] = None) -> HeadPlan:
    """Pick the kernel instance and its layout for one shape. Pure host code.

    The streaming instance takes C <= 32 when D is a whole number of 16-byte
    vectors and its block fits shared memory. Otherwise the cluster instance
    takes Q = ceil(C / class_slice) <= 8 ranks with 128-aligned class
    slices for the classifier, and rank r takes tile rows r, r + Q, ...
    through the tree phases. Tiles hold 16 rows, or up to ``min(block_b,
    20)`` when ``clusters`` (how many clusters the card holds at once) says
    that fits the batch into one wave. Raises ``ValueError`` when no
    instance fits, as the TPU kernel does when it cannot fit VMEM."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"soft_head takes f32 or bf16 W, not {dtype}")
    wbytes = 4 if dtype == torch.float32 else 2
    S = N * K
    nnz_s, nnz_c = nnz_slot, nnz_class
    for width, rows in STREAM_WIDTHS:
        if C <= width:
            smem = stream_smem_bytes(D, C, S, nnz_s, nnz_c, wbytes, rows)
            if D % (16 // wbytes) == 0 and smem <= SMEM_LIMIT:
                return HeadPlan("stream", rows, 1, C, smem, _cdiv(B, WARPS * rows))
            break
    q = min(MAX_RANKS, _cdiv(C, CLASS_SLICE))
    class_slice = _round_up(_cdiv(C, q), CLASS_SLICE)
    q = _cdiv(C, class_slice)  # every rank holds some classes
    # the lists in shared memory where they fit (the feats chunks ride the W
    # ring, so a shallower ring would never make room: the tree region is
    # the larger wherever the ring's is near the limit)
    for lists in (True, False):
        smem = cluster_smem_bytes(D, C, S, nnz_s, nnz_c, wbytes, q, class_slice, W_STAGES, lists)
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(
            f"soft_head: no kernel instance fits D={D}, C={C}, N*K={S}: a cluster "
            f"block needs {smem} bytes of shared memory, over {SMEM_LIMIT}; use the "
            "plain rules (nbdt_torch.rules) for this tree")
    rows = min(max(1, block_b), TILE_ROWS)
    rows = min(rows, 16 if not clusters else max(16, _cdiv(B, clusters)))
    return HeadPlan("cluster", rows, q, class_slice, smem, _cdiv(B, rows) * q, lists, W_STAGES)


def head_plan(hc: HeadConstants, B: int, block_b: int = BLOCK_B,
              clusters: Optional[int] = None) -> HeadPlan:
    """The plan for ``hc`` at batch ``B`` (:func:`plan_soft_head`)."""
    return plan_soft_head(B, hc.W.shape[0], hc.num_classes, hc.num_nodes, hc.max_children,
                          hc.W.dtype, hc.slot_cls.numel(), hc.class_slot.numel(), block_b,
                          clusters)


@functools.lru_cache(maxsize=64)
def max_clusters(q: int, smem_bytes: int, bf16: bool, device_index: int) -> int:
    """Clusters of ``q`` cluster-instance blocks the card holds at once, from
    CUDA's occupancy calculator; raises when it cannot hold one."""
    lib = _library()
    n = lib.nbdt_soft_head_max_clusters(q, smem_bytes, int(bf16), device_index)
    if n < 0:
        raise RuntimeError(
            f"soft_head: occupancy query failed: {lib.nbdt_cuda_error_string(-n).decode()}")
    if n < 1:
        raise ValueError(f"soft_head: a cluster of {q} blocks with {smem_bytes} bytes of "
                         "shared memory each cannot be placed on this card")
    return n


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (pointers and the
    stream as c_void_p, so ctypes does not cut them to 32 bits)."""
    lib = load_library("soft_head")
    lib.nbdt_soft_head_smem_bytes.restype = ctypes.c_size_t
    lib.nbdt_soft_head_smem_bytes.argtypes = [ctypes.c_int] * 11
    lib.nbdt_soft_head_max_clusters.restype = ctypes.c_int
    lib.nbdt_soft_head_max_clusters.argtypes = [ctypes.c_int, ctypes.c_size_t, ctypes.c_int,
                                                ctypes.c_int]
    lib.nbdt_soft_head.restype = ctypes.c_int
    lib.nbdt_soft_head.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 14 + [ctypes.c_void_p] * 2)
    lib.nbdt_cuda_error_string.restype = ctypes.c_char_p
    lib.nbdt_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def fused_soft_head(
    feats: torch.Tensor,
    hc: HeadConstants,
    block_b: int = BLOCK_B,
    want_aux: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Run the fused head: feats [B, D] -> (leaf_logp [B, C][, logits [B, C],
    node_logp [B, N*K]]), node_logp node-major with padded slots = -1e30.
    ``want_aux=False`` returns only the leaf log-probs and writes nothing
    else. feats is cast to W's dtype, as in the JAX package. ``block_b``
    caps the rows of a cluster tile (:func:`plan_soft_head`)."""
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
    if not feats.is_contiguous():
        raise ValueError("soft_head needs contiguous feats")
    feats = aligned(feats)  # the kernel's 16-byte loads

    B, D = feats.shape
    N, K, C = hc.num_nodes, hc.max_children, hc.num_classes
    S = N * K
    plan = head_plan(hc, B, block_b)
    if plan.instance == "cluster" and B > 0:
        clusters = max_clusters(plan.q, plan.smem_bytes, hc.W.dtype == torch.bfloat16,
                                feats.device.index or 0)
        plan = head_plan(hc, B, block_b, clusters)
    leaf = torch.empty(B, C, device=feats.device, dtype=torch.float32)
    logits = logp = None
    if want_aux:
        logits = torch.empty(B, C, device=feats.device, dtype=torch.float32)
        logp = torch.empty(B, S, device=feats.device, dtype=torch.float32)
    if B == 0:
        return (leaf, logits, logp) if want_aux else (leaf,)

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    lib = _library()
    info = (ctypes.c_int * 2)()
    stream = torch.cuda.current_stream(feats.device)
    err = lib.nbdt_soft_head(
        ptr(feats), ptr(hc.W), ptr(hc.b), ptr(hc.slot_ptr), ptr(hc.slot_cls),
        ptr(hc.slot_w), ptr(hc.slot_valid), ptr(hc.class_ptr), ptr(hc.class_slot),
        ptr(leaf), ptr(logits), ptr(logp),
        B, D, C, N, K, hc.slot_cls.numel(), hc.class_slot.numel(),
        int(hc.W.dtype == torch.bfloat16), int(plan.instance == "cluster"), plan.rows,
        plan.q, plan.class_slice, plan.stages, feats.device.index or 0,
        ctypes.c_void_p(stream.cuda_stream), info,
    )
    if err != 0:
        raise RuntimeError(
            f"soft_head launch failed ({plan.instance} instance, q={plan.q}, "
            f"{plan.smem_bytes} bytes of shared memory): "
            f"{lib.nbdt_cuda_error_string(err).decode()} ({err})")
    launches += 1
    last_launch.update(plan=plan, grid=info[0], resident=info[1])
    return (leaf, logits, logp) if want_aux else (leaf,)


def make_fused_soft_head(ta: TreeArrays, fc_kernel, fc_bias=None,
                         block_b: int = BLOCK_B, device="cuda"):
    """Returns ``feats -> (leaf_logp, logits)`` over constants built once."""
    hc = prepare_head_constants(ta, np.asarray(fc_kernel), fc_bias, device=device)

    def head(feats):
        leaf, logits, _ = fused_soft_head(feats, hc, block_b=block_b)
        return leaf, logits

    return head
