"""The work of the benchmark's layers, counted from shapes, and the
published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at a 700 W power limit).

FLOPs are those of the matrix products and convolutions, 2 per
multiply-add, counted as direct convolution by
``torch.utils.flop_counter.FlopCounterMode`` on the reference modules; the
benchmark's tests hold the counts to the published architectures. An FFT
or Winograd convolution does fewer. Elementwise work is not counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: operations at the f32 peak or
    bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def tree_sizes(h) -> dict:
    """Sizes of a hierarchy: classes, real child slots, and the (slot,
    class) pairs with the class under the slot."""
    slots = h.slots
    pairs = sum(len(h.leaves_under[h.children[n][k]]) for n, k in slots)
    return {"C": len(h.wnids), "S": len(slots), "pairs": pairs}


def flops_per_image(build, h, image_size: int, train: bool = False) -> int:
    """Matrix FLOPs of one image through the reference, counted by
    ``FlopCounterMode`` on the meta device (no device runs): ``build()``
    makes the reference model, which takes NCHW images of ``image_size``.
    Served: the backbone, its classifier and the soft rules. With ``train``:
    one SoftTreeSupLoss SGD step of ``reference/train.py``, forward and
    backward (no gradient of the images)."""
    from benchmark.reference.train import SoftTreeSupSGD
    from benchmark.reference.tree import SoftRules

    batch = 2  # BatchNorm's training statistics need more than one value
    counter = FlopCounterMode(display=False)
    with torch.device("meta"):
        model, rules = build(), SoftRules(h, "meta")
        x = torch.empty(batch, 3, image_size, image_size)
        if train:
            y = torch.zeros(batch, dtype=torch.long)
            with counter:
                SoftTreeSupSGD(model, rules, 0.1, 0.9, 0.0).step(x, y)
        else:
            with counter, torch.no_grad():
                rules.probs(model.eval()(x))
    return counter.get_total_flops() // batch


def head_work(h, batch: int, dim: int) -> dict:
    """The fused head's work on ``batch`` rows of ``dim`` f32 features:
    classifier ``[dim, C]`` and bias read once, the tree as index lists
    (slot offsets, each slot's classes and weights, each slot's validity,
    class offsets, each class's slots) read once, features read once and
    the class log-probabilities written once; the classifier's products and
    the tree's operations (two per (slot, class) pair for the node logits,
    one per pair for the path sums, four per slot for the log-softmax)."""
    t = tree_sizes(h)
    C, S, pairs = t["C"], t["S"], t["pairs"]
    tree_bytes = 4 * (S + 1) + 8 * pairs + S + 4 * (C + 1) + 4 * pairs
    nbytes = 4 * batch * dim + 4 * dim * C + 4 * C + tree_bytes + 4 * batch * C
    flops = 2 * batch * dim * C + batch * (3 * pairs + 4 * S)
    return {"flops": flops, "bytes": nbytes}


def layernorm_work(rows: int, dim: int) -> dict:
    """LayerNorm of ``rows`` f32 rows of ``dim``: input read and output
    written once, weight and bias read once; 8 operations per element
    (sum, centre, square, accumulate, scale, normalize, affine)."""
    return {"flops": 8 * rows * dim, "bytes": 8 * rows * dim + 8 * dim}
