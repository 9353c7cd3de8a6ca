"""The work of one forward of a port backbone, counted from shapes on the
meta device: no device runs, so the output is operations and bytes, never
a time.

    python -m nbdt_torch.tools.count_work --arch efficientnet_b7b --batch 64 --image 600

Prints one JSON line: the FLOPs of the forward (``torch.utils.flop_counter``),
the convolutions' FLOPs split into dense and grouped (depthwise) ones, and
the bytes each aten op reads and writes, counting each of its input and
output tensors once, in the module's dtype, channels-last as the NBDT
wrappers run it.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


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
               dtype: torch.dtype = torch.float32) -> dict:
    from ..models import get_model

    convs = {"dense": 0, "grouped": 0}

    def hook(m, _, out):
        kind = "grouped" if m.groups > 1 else "dense"
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        convs[kind] += 2 * out.numel() * k

    with torch.device("meta"):
        model = get_model(arch, num_classes, dtype=dtype, image_size=image).eval()
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
    return {"arch": arch, "batch": batch, "image": image, "dtype": str(dtype)[6:],
            "flops": flops.get_total_flops(), "conv_flops": convs,
            "bytes_by_op": dict(sorted(moved.by_op.items(), key=lambda kv: -kv[1])),
            "bytes": sum(moved.by_op.values())}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--arch", required=True)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--image", type=int, default=224)
    parser.add_argument("--classes", type=int, default=1000)
    parser.add_argument("--bf16", action="store_true", help="a bf16 stream")
    args = parser.parse_args(argv)
    print(json.dumps(count_work(args.arch, args.batch, args.image, args.classes,
                                torch.bfloat16 if args.bf16 else torch.float32)))


if __name__ == "__main__":
    main()
