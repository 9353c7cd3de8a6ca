"""The work of one forward of a port backbone, counted from shapes on the
meta device: no device runs, so the output is operations and bytes, never
a measured time.

    python -m nbdt_torch.tools.count_work --arch efficientnet_b7b --batch 64 --image 600
    python -m nbdt_torch.tools.count_work --arch alexnet --batch 256 --head Imagenet1000
    python -m nbdt_torch.tools.count_work --arch vgg16_bn --classic-head --batch 256

Prints one JSON line: the FLOPs of the forward (``torch.utils.flop_counter``),
the convolutions' FLOPs split into dense and grouped (depthwise) ones, and
the bytes each aten op reads and writes, counting each of its input and
output tensors once, in the module's dtype, channels-last as the NBDT
wrappers run it. With ``--head DATASET``, also the work of the fused head
(B1) on that dataset's induced tree at the backbone's feature width,
f32 W: its bytes, classifier FLOPs and tree operations, and the least time
an H100 could take for them at its published peaks (``head_bound_ms``,
which ``chip_smoke.py`` uses too).
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


# Published H100 SXM peaks (NVIDIA's data sheet, at a 700 W power limit):
# HBM bytes/s, f32 (non-tensor-core) FLOP/s and bf16 tensor-core FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def head_work(hc, B: int, D: int) -> dict:
    """The fused head's work on ``B`` rows of ``D`` features with head
    constants ``hc``: every input read once (the feats in W's dtype) and the
    leaf log-probs written once, the classifier's FLOPs, and the tree lists'
    f32 operations."""
    consts = (hc.W, hc.b, hc.slot_ptr, hc.slot_cls, hc.slot_w, hc.slot_valid,
              hc.class_ptr, hc.class_slot)
    nbytes = B * D * hc.W.element_size() + sum(t.numel() * t.element_size() for t in consts)
    nbytes += B * hc.num_classes * 4
    S = hc.num_nodes * hc.max_children
    return {"bytes": nbytes, "classifier_flops": 2 * B * D * hc.num_classes,
            "tree_flops": B * (2 * hc.slot_cls.numel() + hc.class_slot.numel() + 4 * S)}


def head_bound_ms(hc, B: int, D: int) -> tuple:
    """(least ms for the head on an H100, "bytes" or "operations"): its
    bytes at HBM rate vs its operations at their peaks, the classifier at
    the f32 CUDA-core peak for an f32 W (TF32 is ruled out) or the bf16
    tensor-core peak for a bf16 W, the tree lists' f32 operations at the f32
    peak."""
    work = head_work(hc, B, D)
    peak = PEAK_F32_FLOPS if hc.W.dtype == torch.float32 else PEAK_BF16_FLOPS
    t_bytes = work["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = (work["classifier_flops"] / peak + work["tree_flops"] / PEAK_F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class _Bytes(TorchDispatchMode):
    """Bytes of every aten op's tensor inputs and outputs, by op name."""

    def __init__(self):
        super().__init__()
        self.by_op: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        tensors = [t for t in tree_leaves((args, kwargs, out)) if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__
        self.by_op[name] = self.by_op.get(name, 0) + sum(
            t.numel() * t.element_size() for t in tensors)
        return out


def count_work(arch: str, batch: int, image: int, num_classes: int = 1000,
               dtype: torch.dtype = torch.float32, **kw) -> dict:
    """The forward's work; ``kw`` go to the backbone's constructor."""
    from ..models import get_model

    convs = {"dense": 0, "grouped": 0}

    def hook(m, _, out):
        kind = "grouped" if m.groups > 1 else "dense"
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        convs[kind] += 2 * out.numel() * k

    with torch.device("meta"):
        model = get_model(arch, num_classes, dtype=dtype, image_size=image, **kw).eval()
        model = model.to(memory_format=torch.channels_last)
        hooks = [m.register_forward_hook(hook) for m in model.modules()
                 if isinstance(m, torch.nn.Conv2d)]
        x = torch.empty(batch, 3, image, image).to(memory_format=torch.channels_last)
        flops = FlopCounterMode(display=False)
        with torch.no_grad(), flops:
            model(x)
        for h in hooks:
            h.remove()
        moved = _Bytes()
        with torch.no_grad(), moved:
            model(x)
        try:
            with torch.no_grad():
                features = model(x, features_only=True).shape[1]
        except NotImplementedError:  # SqueezeNet: no pooled features
            features = None
    return {"arch": arch, "batch": batch, "image": image, "dtype": str(dtype)[6:],
            "flops": flops.get_total_flops(), "conv_flops": convs,
            "bytes_by_op": dict(sorted(moved.by_op.items(), key=lambda kv: -kv[1])),
            "bytes": sum(moved.by_op.values()), "features": features}


def count_head(dataset: str, batch: int, dim: int) -> dict:
    """The fused head's work and bound on a dataset's vendored induced tree,
    f32 W of zeros (the work does not depend on the values)."""
    import numpy as np

    from ..ops.soft_traversal import prepare_head_constants
    from ..tree import Tree

    ta = Tree(dataset).arrays
    hc = prepare_head_constants(ta, np.zeros((dim, ta.num_classes), np.float32), None,
                                device="cpu")
    bound, by = head_bound_ms(hc, batch, dim)
    return {"dataset": dataset, "batch": batch, "features": dim,
            "classes": ta.num_classes, **head_work(hc, batch, dim),
            "bound_ms_at_h100_peaks": bound, "bound_by": by}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--arch", required=True)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--image", type=int, default=224)
    parser.add_argument("--classes", type=int, default=1000)
    parser.add_argument("--bf16", action="store_true", help="a bf16 stream")
    parser.add_argument("--classic-head", action="store_true",
                        help="a VGG with torchvision's head (classic_head=True)")
    parser.add_argument("--head", metavar="DATASET", default=None,
                        help="also the fused head's work on this dataset's tree")
    args = parser.parse_args(argv)
    out = count_work(args.arch, args.batch, args.image, args.classes,
                     torch.bfloat16 if args.bf16 else torch.float32,
                     **({"classic_head": True} if args.classic_head else {}))
    if args.head:
        if out["features"] is None:
            parser.error(f"{args.arch} has no pooled features for the fused head")
        out["head"] = count_head(args.head, args.batch, out["features"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
