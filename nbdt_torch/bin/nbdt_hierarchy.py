"""Hierarchy generation CLI: build a hierarchy (induced, WordNet or random),
check it, and write its HTML.

Counterpart of ``nbdt_tpu/bin/nbdt_hierarchy.py``, with ``--device`` where
the JAX CLI has ``--platform``:

    python -m nbdt_torch.bin.nbdt_hierarchy --dataset CIFAR10 --method wordnet \
        --mini-corpus nbdt_tpu/hierarchies/CIFAR10/graph-wordnet.json \
        --hierarchies-root out/hierarchies

The induced method takes its class centers from a torch ``.pth`` or the JAX
package's ``.msgpack`` (``--checkpoint``) or from ``--arch`` at a seeded
random init, built on ``--device`` (CUDA unless ``--device cpu``). Nothing
is downloaded: offline, ``--mini-corpus`` stands in for the NLTK WordNet
corpus.
"""

from __future__ import annotations

import argparse


def get_parser() -> argparse.ArgumentParser:
    from ..utils import DATASETS, METHODS

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", default="CIFAR10", choices=DATASETS)
    parser.add_argument("--method", default="induced", choices=METHODS)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--branching-factor", type=int, default=2)
    parser.add_argument("--extra", type=int, default=0,
                        help="percent extra nodes to add")
    parser.add_argument("--no-prune", action="store_true")
    parser.add_argument("--fname", default="")
    parser.add_argument("--path", default="")
    parser.add_argument("--single-path", action="store_true",
                        help="allow each leaf multiple paths to the root "
                             "(the reference's spelling: its single_path "
                             "is passed on as the builder's multi_path)")
    parser.add_argument("--multi-path", dest="single_path",
                        action="store_true", help="alias for --single-path")
    parser.add_argument("--induced-linkage", default="ward")
    parser.add_argument("--induced-affinity", default="euclidean")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--arch", default=None)
    parser.add_argument("--hierarchies-root", default=None)
    parser.add_argument("--force", action="store_true",
                        help="allow overwriting a vendored hierarchy JSON "
                             "(protected by default)")
    parser.add_argument("--vis-out-dir", default="out")
    parser.add_argument("--no-vis", action="store_true")
    # Visualization customization (reference graph.py --vis-* family).
    parser.add_argument("--vis-out-fname", default=None)
    parser.add_argument("--vis-theme", default="regular",
                        choices=["regular", "dark", "minimal"])
    parser.add_argument("--vis-zoom", type=float, default=1.0)
    parser.add_argument("--vis-curved", action="store_true", default=True)
    parser.add_argument("--vis-straight", dest="vis_curved",
                        action="store_false",
                        help="straight links instead of curved")
    parser.add_argument("--vis-sublabels", action="store_true",
                        help="show wnid sublabels")
    parser.add_argument("--vis-fake-sublabels", action="store_true",
                        help="show generated (f-) wnid sublabels too")
    parser.add_argument("--vis-no-color-leaves", action="store_true")
    parser.add_argument("--vis-color-path-to", default=None,
                        help="highlight the root path to this wnid or label")
    parser.add_argument("--vis-root", default=None,
                        help="render only the subtree under this wnid")
    parser.add_argument("--vis-hide", nargs="*", default=[],
                        help="wnids whose subtrees are hidden")
    parser.add_argument("--vis-collapse", nargs="*", default=[],
                        help="wnids whose subtrees start collapsed "
                             "(expandable by click, like the reference's "
                             "--vis-hide auto-click behavior)")
    parser.add_argument("--vis-force-labels-left", nargs="*", default=[])
    parser.add_argument("--vis-width", type=int, default=0)
    parser.add_argument("--vis-height", type=int, default=0)
    parser.add_argument("--vis-margin-top", type=int, default=0)
    parser.add_argument("--vis-margin-left", type=int, default=0)
    parser.add_argument("--vis-above-dy", type=int, default=0)
    parser.add_argument("--vis-below-dy", type=int, default=0)
    parser.add_argument("--vis-leaf-images", action="store_true",
                        help="embed one sample image per leaf from the "
                             "dataset (skipped when data is not on disk)")
    parser.add_argument("--vis-image-resize-factor", type=float, default=1.0,
                        help="scale factor for embedded leaf images")
    parser.add_argument("--vis-color-nodes", nargs="*", default=(),
                        help="extra wnids/labels drawn in the highlight color")
    parser.add_argument("--vis-node-conf", nargs=3, action="append",
                        default=[], metavar=("WNID", "KEY", "VALUE"),
                        help="per-node template override (dot-notation key)")
    parser.add_argument("--vis-scale", type=float, default=1.0,
                        help="scale the whole rendering")
    parser.add_argument("--vis-root-y", default="null",
                        help="pin the root's vertical position (px)")
    parser.add_argument("--vis-colormap", default="colormap_annotated.png",
                        help="legend image embedded when the file exists")
    parser.add_argument("--color", default=None,
                        choices=[None, "blue", "blue-green", "blue-minimal"],
                        help="named highlight palette for colored nodes "
                             "(reference graph.py:119-126)")
    parser.add_argument("--data-root", default="./data")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the induced method's model (default: cuda)")
    parser.add_argument(
        "--mini-corpus", default=None,
        help="vendored mini WordNet: a corpus table JSON or a vendored "
             "wordnet hierarchy JSON (chains derived from it); lets "
             "--method wordnet and hypernym naming run offline")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)

    from ..assets import get_dataset_wnids
    from ..hierarchy.generate import generate_hierarchy, resolve_centers, test_hierarchy
    from ..hierarchy.vis import generate_hierarchy_vis
    from ..utils import Colors, resolve_device

    if args.mini_corpus:
        from ..hierarchy.wnid import install_mini_corpus

        install_mini_corpus(args.mini_corpus)

    wnids = get_dataset_wnids(args.dataset)

    centers = None
    if args.method == "induced" and not args.checkpoint:
        # the registered arch at a seeded random init
        if not args.arch:
            raise SystemExit("error: --method induced needs --arch or --checkpoint")
        import torch

        from ..models import get_model

        device = resolve_device(args.device)
        torch.manual_seed(0)
        size = 64 if args.dataset == "TinyImagenet200" else 32
        centers = resolve_centers(model=get_model(args.arch, len(wnids),
                                                  image_size=size).to(device))

    try:
        path = generate_hierarchy(
            dataset=args.dataset,
            method=args.method,
            seed=args.seed,
            branching_factor=args.branching_factor,
            extra=args.extra,
            no_prune=args.no_prune,
            fname=args.fname,
            path=args.path,
            multi_path=args.single_path,
            induced_linkage=args.induced_linkage,
            induced_affinity=args.induced_affinity,
            checkpoint=args.checkpoint,
            arch=args.arch,
            centers=centers,
            wnids=wnids,
            hierarchies_root=args.hierarchies_root,
            force=args.force,
        )
    except (FileExistsError, NotImplementedError) as e:
        Colors.red(f"==> {e}")
        raise SystemExit(1)
    test_hierarchy(args.dataset, path, wnids=wnids)
    wnid_to_image = None
    if args.vis_leaf_images and not args.no_vis:
        # one sample per class from the dataset, keyed by leaf wnid
        try:
            import numpy as np

            from ..data import get_dataset

            ds = get_dataset(args.dataset)(root=args.data_root, train=True)
            labels = np.asarray(ds.labels)
            wnid_to_image = {}
            for c, w in enumerate(wnids):
                idx = np.flatnonzero(labels == c)
                if len(idx):
                    wnid_to_image[w] = ds.images[idx[0]]
        except Exception as e:  # no dataset on disk: the page has no images
            print(f"==> --vis-leaf-images skipped ({type(e).__name__}: {e})")
    if not args.no_vis:
        generate_hierarchy_vis(
            args.dataset, path, out_dir=args.vis_out_dir,
            out_fname=args.vis_out_fname,
            theme=args.vis_theme,
            zoom=args.vis_zoom,
            curved=args.vis_curved,
            sublabels=args.vis_sublabels,
            fake_sublabels=args.vis_fake_sublabels,
            color_leaves=not args.vis_no_color_leaves,
            color_path_to=args.vis_color_path_to,
            vis_root=args.vis_root,
            hide=args.vis_hide,
            collapse=args.vis_collapse,
            force_labels_left=args.vis_force_labels_left,
            width=args.vis_width,
            height=args.vis_height,
            margin_top=args.vis_margin_top,
            margin_left=args.vis_margin_left,
            above_dy=args.vis_above_dy,
            below_dy=args.vis_below_dy,
            wnid_to_image=wnid_to_image,
            image_resize_factor=args.vis_image_resize_factor,
            color_nodes=args.vis_color_nodes,
            node_conf=args.vis_node_conf,
            scale=args.vis_scale,
            root_y=args.vis_root_y,
            colormap=args.vis_colormap,
            color=args.color,
        )


if __name__ == "__main__":
    main()
