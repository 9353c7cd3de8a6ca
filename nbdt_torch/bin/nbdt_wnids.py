"""Write a dataset's wnid list: class names to WordNet noun synsets.

Counterpart of ``nbdt_tpu/bin/nbdt_wnids.py``:

    python -m nbdt_torch.bin.nbdt_wnids --dataset CIFAR10 --root out/wnids

A dataset with a vendored wnid list (``nbdt_tpu/wnids/<dataset>.txt``) and
no ``--classes`` gets that list. Otherwise each class name maps to its
first WordNet noun synset, with the reference's hand-made sense maps, or to
a FakeSynset wnid (``f<class index>``) where nothing resolves it. This needs
the NLTK WordNet corpus, which is never downloaded: without it every name
falls back, as the JAX CLI does when its download fails. One wnid per line,
in class order.
"""

from __future__ import annotations

import argparse
import os

# Class names whose first WordNet noun synset is the wrong sense —
# supplementary senses for keys the reference map below does not cover
# (keys present in REFERENCE_SYNSET_INDEX always win, so no overlaps live
# here).
DISAMBIGUATION = {
    "airplane": "airplane.n.01",
    "automobile": "car.n.01",
    "crab": "crab.n.01",
    "oak_tree": "oak.n.02",
    "palm_tree": "palm.n.03",
    "pine_tree": "pine.n.01",
    "willow_tree": "willow.n.01",
    "tank": "tank.n.01",
    "tractor": "tractor.n.01",
    "train": "train.n.01",
    "plain": "plain.n.01",
    "keyboard": "keyboard.n.01",
    "lawn_mower": "lawn_mower.n.01",
    "man": "man.n.01",
    "woman": "woman.n.01",
    "boy": "male_child.n.01",
    "girl": "girl.n.01",
    "baby": "baby.n.01",
}

# The reference's hand-curated sense map (bin/nbdt-wnids:69-128), reproduced
# with its exact (query word, synset index) semantics: the value selects
# wn.synsets(word, NOUN)[index] at runtime, so no corpus is needed to author
# the table and the resolved wnids match the reference's outputs verbatim.
# Covers the segmentation class vocabularies (ADE20K, PascalContext,
# LookIntoPerson, Cityscapes) plus CIFAR100 animal senses.
REFERENCE_SYNSET_INDEX = {
    "aquarium_fish": ("fingerling", 0),
    "arcade_machine": ("slot_machine", 0),
    "background": ("background", 1),
    "barrel": ("barrel", 1),
    "beaver": ("beaver", -1),
    "booth": ("booth", 1),
    "blind": ("blind", 2),
    "bulletin_board": ("bulletin_board", 1),
    "canopy": ("canopy", 2),
    "case": ("case", -1),
    "castle": ("castle", 1),
    "column": ("column", 5),
    "cushion": ("cushion", 2),
    "diningtable": ("dining_table", 0),
    "earth": ("earth", 1),
    "escalator": ("escalator", 1),
    "flatfish": ("flatfish", 1),
    "food": ("food", 1),
    "glove": ("glove", 1),
    "grandstand": ("grandstand", 1),
    "lamp": ("lamp", 1),
    "land": ("land", 1),
    "leopard": ("leopard", 1),
    "left_arm": ("arm", 0),
    "left_leg": ("leg", 0),
    "left_shoe": ("shoe", 0),
    "lobster": ("lobster", 1),
    "maple_tree": ("maple", 1),
    "microwave": ("microwave", 1),
    "monitor": ("monitor", 3),
    "otter": ("otter", 1),
    "ottoman": ("ottoman", 2),
    "path": ("path", 2),
    "plant": ("plant", 1),
    "plate": ("plate", 3),
    "pottedplant": ("plant", 1),
    "raccoon": ("raccoon", 1),
    "radiator": ("radiator", 1),
    "ray": ("ray", -1),
    "rider": ("rider", 2),
    "runway": ("runway", 3),
    "seal": ("seal", -1),
    "shrew": ("shrew", 1),
    "sign": ("sign", 1),
    "skunk": ("skunk", 1),
    "stage": ("stage", 2),
    "step": ("step", 3),
    "table": ("table", 1),
    "tiger": ("tiger", 1),
    "toilet": ("toilet", 1),
    "traffic_sign": ("street_sign", 0),
    "turtle": ("turtle", 1),
    "tvmonitor": ("tv_monitor", 0),
    "upper_clothes": ("top", 9),
    "van": ("van", -1),
    "washer": ("washer", 2),
    "water": ("water", 1),
    "whale": ("whale", 1),
}


def class_to_wnid(name: str, offset_fallback: int) -> str:
    """The wnid of a class name through the NLTK WordNet corpus and the
    sense maps, or ``f<offset_fallback>`` where no corpus or sense resolves
    it."""
    from ..hierarchy.wnid import FakeSynset, synset_to_wnid, wordnet_available

    if not wordnet_available():
        return FakeSynset.create_from_offset(offset_fallback).wnid
    from nltk.corpus import wordnet as wn

    key = name.strip().lower().replace(" ", "_").replace("-", "_")
    try:
        if key in REFERENCE_SYNSET_INDEX:
            word, index = REFERENCE_SYNSET_INDEX[key]
            synset = wn.synsets(word, pos="n")[index]
        elif key in DISAMBIGUATION:
            synset = wn.synset(DISAMBIGUATION[key])
        else:
            synsets = wn.synsets(key, pos="n")
            if not synsets:
                return FakeSynset.create_from_offset(offset_fallback).wnid
            synset = synsets[0]
        return synset_to_wnid(synset)
    except Exception:  # a sense index or synset name the corpus lacks
        return FakeSynset.create_from_offset(offset_fallback).wnid


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", default="CIFAR10")
    parser.add_argument("--classes", nargs="*", default=None,
                        help="explicit class names (else the dataset's)")
    parser.add_argument("--root", default="./out/wnids",
                        help="output directory of <dataset>.txt (never the vendored lists')")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)

    from ..assets import get_dataset_wnids
    from ..hierarchy.wnid import maybe_install_wordnet, write_wnids
    from ..utils import ASSETS_ROOT, DATASET_TO_CLASSES, dataset_to_default_path_wnids

    maybe_install_wordnet()
    classes = args.classes or DATASET_TO_CLASSES.get(args.dataset)
    if not classes:
        raise SystemExit(f"error: no class names known for {args.dataset}; pass --classes")
    if args.classes is None and os.path.exists(dataset_to_default_path_wnids(args.dataset)):
        wnids = get_dataset_wnids(args.dataset)
    else:
        wnids = [class_to_wnid(c, i) for i, c in enumerate(classes)]
    failures = [c for c, w in zip(classes, wnids) if w.startswith("f")]
    path = os.path.join(args.root, f"{args.dataset}.txt")
    if os.path.realpath(path).startswith(os.path.realpath(ASSETS_ROOT) + os.sep):
        raise SystemExit(f"error: refusing to write {path} into the vendored data files")
    write_wnids(wnids, path)
    print(f"==> Wrote {len(wnids)} wnids to {path}")
    if failures:
        print(f"==> {len(failures)} classes fell back to FakeSynset: {failures}")


if __name__ == "__main__":
    main()
