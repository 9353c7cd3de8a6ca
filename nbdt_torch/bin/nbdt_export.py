"""Export a trained NBDT to a self-contained serving artifact (counterpart
of ``nbdt_tpu/bin/nbdt_export.py``, with ``--device`` where the JAX CLI has
``--platform``/``--platforms``):

    python -m nbdt_torch.bin.nbdt_export --arch ResNet18 --dataset CIFAR10 \\
        [--checkpoint ckpt.pth|ckpt.msgpack] [--hierarchy induced-ResNet18] \\
        --out nbdt.pt2 [--f32] [--fold-bn] [--uint8-input] [--image-size N]

The artifact is a ``torch.export`` program with a symbolic batch that holds
the weights and the tree constants: load it with
``nbdt_torch.serving.load_serving``, with no model code, checkpoint or
hierarchy JSON. Without ``--checkpoint`` or ``--random-init`` the released
checkpoint is read from the local cache (``$NBDT_CHECKPOINT_DIR``).
"""

from __future__ import annotations

import argparse
import os

_DEFAULT_SIZE = {"TinyImagenet200": 64, "Imagenet1000": 224}


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--arch", default="ResNet18")
    parser.add_argument("--dataset", default="CIFAR10")
    parser.add_argument("--hierarchy", default=None)
    parser.add_argument("--path-graph", default=None)
    parser.add_argument("--path-wnids", default=None)
    parser.add_argument("--checkpoint", default=None, help="local .pth/.msgpack checkpoint")
    parser.add_argument("--random-init", action="store_true",
                        help="export a randomly initialized backbone (offline smoke test of "
                             "the export pipeline)")
    parser.add_argument("--out", required=True, help="output artifact path (e.g. nbdt.pt2)")
    parser.add_argument("--image-size", type=int, default=None,
                        help="input HxW (default: 32; 64 TinyImagenet200; 224 Imagenet1000)")
    parser.add_argument("--f32", action="store_true",
                        help="keep the backbone in f32 (default: bf16 backbone, f32 node "
                             "decisions)")
    parser.add_argument("--fold-bn", action="store_true",
                        help="fold BatchNorm into conv weights before export (ResNet family)")
    parser.add_argument("--uint8-input", action="store_true",
                        help="artifact takes raw uint8 NHWC and normalizes on the device with "
                             "the dataset's constants (4x smaller request payloads)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the program is traced on (default: cuda)")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)

    from .. import data
    from ..serving import export_serving
    from .nbdt import build_model

    size = args.image_size or _DEFAULT_SIZE.get(args.dataset, 32)
    normalize = None
    if args.uint8_input:
        # the dataset classes own their normalization constants
        ds_cls = getattr(data, args.dataset, None)
        if ds_cls is None or not (hasattr(ds_cls, "mean") and hasattr(ds_cls, "std")):
            raise SystemExit(f"--uint8-input: no normalization constants for {args.dataset}; "
                             "use the float-input export")
        normalize = (ds_cls.mean, ds_cls.std)
    nbdt = build_model(args.arch, args.dataset, args.hierarchy, args.path_graph,
                       args.path_wnids, args.checkpoint, random_init=args.random_init,
                       device=args.device, image_size=size)
    path = export_serving(nbdt.model, nbdt.tree, args.out, image_size=size, bf16=not args.f32,
                          fold_bn=args.fold_bn, uint8_input=args.uint8_input,
                          normalize=normalize, device=args.device)
    print(f"==> Exported {args.arch}/{args.dataset} serving artifact to {path} "
          f"({os.path.getsize(path) / 1e6:.1f} MB, device={args.device}, "
          f"input [b,{size},{size},3])")


if __name__ == "__main__":
    main()
