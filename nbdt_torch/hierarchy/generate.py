"""Classifier probe, class centers, graph file names, hierarchy generation
and checks.

Counterpart of ``nbdt_tpu/hierarchy/generate.py``. ``generate_hierarchy``
builds an induced, WordNet or random hierarchy, prunes and augments it and
writes the reference's node-link JSON. Induced centers are the rows of a
classifier, taken from a torch module (the first ``nn.Linear`` among
:data:`CLASSIFIER_NAMES`), a state dict, a local ``.pth``, or given as an
array.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch.nn as nn

from ..utils import ASSETS_ROOT, Colors
from .build import (
    augment_graph,
    build_induced_graph,
    build_minimal_wordnet_graph,
    build_random_graph,
    prune_single_successor_nodes,
)
from .digraph import Digraph, get_depth, get_leaves, get_roots, read_graph, write_graph

# The JAX package's probe order, with pytorchcv's ``output.fc`` (EfficientNet)
# after ``output`` as in MODEL_FC_KEYS, then torchvision's ViT classifier.
CLASSIFIER_NAMES = ("linear", "fc", "classifier", "head", "output", "output.fc", "heads.head")

# Final classifier weight keys of the reference's model zoos, in its order.
MODEL_FC_KEYS = (
    "fc.weight",
    "linear.weight",
    "module.linear.weight",
    "module.net.linear.weight",
    "output.weight",
    "module.output.weight",
    "output.fc.weight",
    "module.output.fc.weight",
    "classifier.weight",
    "model.last_layer.3.weight",
)


def get_classifier_from_module(module: nn.Module):
    """The classifier of a backbone as ``(kernel [D, C], bias [C] or None)``,
    numpy f32: the first ``nn.Linear`` among :data:`CLASSIFIER_NAMES`
    (``weight`` is ``[C, D]``, so it is transposed to the JAX package's
    kernel layout), or ``(None, None)`` if there is none."""
    for name in CLASSIFIER_NAMES:
        try:
            layer = module.get_submodule(name)
        except AttributeError:
            continue
        if isinstance(layer, nn.Linear):
            kernel = layer.weight.detach().float().cpu().numpy().T
            bias = None if layer.bias is None else layer.bias.detach().float().cpu().numpy()
            return np.ascontiguousarray(kernel), bias
    return None, None


def get_centers_from_state_dict(state_dict) -> Optional[np.ndarray]:
    """The final classifier weight ``[C, D]`` of a flat state dict."""
    for key in MODEL_FC_KEYS:
        if key in state_dict:
            value = state_dict[key]
            if hasattr(value, "detach"):
                value = value.detach().float().cpu().numpy()
            return np.asarray(value).squeeze()
    return None


def get_centers_from_checkpoint(checkpoint: str) -> np.ndarray:
    """The classifier weight ``[C, D]`` of a local torch ``.pth``. The JAX
    package's ``.msgpack`` checkpoints are not read yet (ROADMAP A12)."""
    if str(checkpoint).endswith(".msgpack"):
        raise NotImplementedError(
            f"{checkpoint}: reading the JAX package's .msgpack checkpoints is not ported to "
            "nbdt_torch yet (ROADMAP A12); pass a torch .pth")
    from ..model import load_checkpoint

    state_dict = load_checkpoint(checkpoint)
    fc = get_centers_from_state_dict(state_dict)
    if fc is None:
        raise ValueError(f"Could not find FC weights in checkpoint {checkpoint} with keys: "
                         f"{list(state_dict)[:20]}")
    return fc


def resolve_centers(centers=None, state_dict=None, model: Optional[nn.Module] = None,
                    checkpoint: Optional[str] = None) -> np.ndarray:
    """Class centers ``[C, D]`` from the first source given, in the JAX
    package's order: centers, state dict, checkpoint, model."""
    if centers is not None:
        return np.asarray(centers)
    if state_dict is not None:
        fc = get_centers_from_state_dict(state_dict)
        if fc is None:
            raise ValueError(f"No FC key found in state dict: {list(state_dict)[:20]}")
        return fc
    if checkpoint is not None:
        return get_centers_from_checkpoint(checkpoint)
    if model is not None:
        kernel, _ = get_classifier_from_module(model)
        if kernel is None:
            raise ValueError(
                f"A model was given but it has no nn.Linear named one of {CLASSIFIER_NAMES}; "
                f"pass centers= directly. Model type: {type(model).__name__}")
        return kernel.T
    raise ValueError("Need one of `centers`, `state_dict`, `checkpoint`, `model` to induce a "
                     "hierarchy.")


def generate_graph_fname(
    method,
    seed=0,
    branching_factor=2,
    extra=0,
    no_prune=False,
    fname="",
    path="",
    multi_path=False,
    induced_linkage="ward",
    induced_affinity="euclidean",
    checkpoint=None,
    arch=None,
    **kwargs,
):
    """The reference's graph file stem for these generation options."""
    if path:
        return Path(path).stem
    if fname:
        return fname
    fname = f"graph-{method}"
    if method == "random" and seed != 0:
        fname += f"-seed{seed}"
    if method == "induced":
        if induced_linkage != "ward" and induced_linkage is not None:
            fname += f"-linkage{induced_linkage}"
        if induced_affinity != "euclidean" and induced_affinity is not None:
            fname += f"-affinity{induced_affinity}"
        if checkpoint:
            stem = Path(checkpoint).stem
            if stem.startswith("ckpt-") and stem.count("-") >= 2:
                checkpoint_fname = "-".join(stem.split("-")[2:]).replace("-induced", "")
            else:
                checkpoint_fname = stem
        else:
            checkpoint_fname = arch
        if checkpoint_fname:
            fname += f"-{checkpoint_fname}"
    if method in ("random", "induced") and branching_factor != 2:
        fname += f"-branch{branching_factor}"
    if extra > 0:
        fname += f"-extra{extra}"
    if no_prune:
        fname += "-noprune"
    if multi_path:
        fname += "-multi"
    return fname


def print_graph_stats(G: Digraph, name: str) -> None:
    num_children = [len(G.succ(n)) for n in G.nodes]
    print("[{}] \t Nodes: {} \t Depth: {} \t Max Children: {}".format(
        name, len(G.nodes), get_depth(G), max(num_children)))


def assert_all_wnids_in_graph(G: Digraph, wnids) -> None:
    missing = [wnid for wnid in wnids if wnid.strip() not in G]
    assert not missing, missing


def get_graph_path_from_args(dataset, method, root=None, path="", **kwargs) -> str:
    """``path``, else ``<root>/<dataset>/<graph fname>.json``; ``root``
    defaults to ``out/hierarchies`` (the vendored hierarchies are the JAX
    package's files, and the port writes none of them by default)."""
    if path:
        return path
    fname = generate_graph_fname(method=method, **kwargs)
    return os.path.join(root or os.path.join("out", "hierarchies"), dataset, f"{fname}.json")


def generate_hierarchy(
    dataset: str,
    method: str = "induced",
    seed: int = 0,
    branching_factor: int = 2,
    extra: int = 0,
    no_prune: bool = False,
    fname: str = "",
    path: str = "",
    multi_path: bool = False,
    induced_linkage: str = "ward",
    induced_affinity: str = "euclidean",
    checkpoint: Optional[str] = None,
    arch: Optional[str] = None,
    model: Optional[nn.Module] = None,
    centers=None,
    state_dict=None,
    wnids: Optional[Sequence[str]] = None,
    hierarchies_root: Optional[str] = None,
    force: bool = False,
) -> str:
    """Build (``method`` "induced", "wordnet" or "random"), prune unless
    ``no_prune``, augment by ``extra`` percent, and write a hierarchy;
    returns the JSON path, which is ``path`` or
    ``<hierarchies_root>/<dataset>/<graph fname>.json``. ``multi_path``
    gives the WordNet builder every hypernym of a synset (the JAX package's
    ``single_path``, which it passes on as ``multi_path``) and the file
    name its "-multi" suffix. Induced centers come from ``centers``,
    ``state_dict``, ``model`` or ``checkpoint`` (which also names the file).
    A file among the JAX package's vendored hierarchies is overwritten only
    with ``force``."""
    if wnids is None:
        from ..assets import get_dataset_wnids

        wnids = get_dataset_wnids(dataset)
    if method == "wordnet":
        G = build_minimal_wordnet_graph(wnids, multi_path)
    elif method == "random":
        G = build_random_graph(wnids, seed=seed, branching_factor=branching_factor)
    elif method == "induced":
        G = build_induced_graph(wnids, resolve_centers(centers, state_dict, model, checkpoint),
                                branching_factor=branching_factor, dataset=dataset)
    else:
        raise NotImplementedError(f'Method "{method}" not yet handled.')
    print_graph_stats(G, "matched")
    assert_all_wnids_in_graph(G, wnids)
    if not no_prune:
        G = prune_single_successor_nodes(G)
        print_graph_stats(G, "pruned")
        assert_all_wnids_in_graph(G, wnids)
    if extra > 0:
        G, n_extra, n_imaginary = augment_graph(G, extra, True)
        print(f"[extra] \t Extras: {n_extra} \t Imaginary: {n_imaginary}")
        print_graph_stats(G, "extra")
        assert_all_wnids_in_graph(G, wnids)

    path = get_graph_path_from_args(
        dataset, method, root=hierarchies_root, path=path, seed=seed,
        branching_factor=branching_factor, extra=extra, no_prune=no_prune, fname=fname,
        multi_path=multi_path and method == "wordnet", induced_linkage=induced_linkage,
        induced_affinity=induced_affinity, checkpoint=checkpoint, arch=arch)
    _guard_vendored_fixture(path, force)
    write_graph(G, path)
    Colors.green("==> Wrote tree to {}".format(path))
    return path


def _guard_vendored_fixture(path, force: bool) -> None:
    """Refuse to overwrite one of the vendored hierarchy JSONs (the parity
    fixtures of both packages) unless ``force``."""
    if force:
        return
    target = Path(path).resolve()
    if target.exists() and target.is_relative_to((ASSETS_ROOT / "hierarchies").resolve()):
        raise FileExistsError(
            f"refusing to overwrite the vendored hierarchy {target}; pass force=True, or "
            "write elsewhere with hierarchies_root= or path=")


def check_hierarchy(G: Digraph, wnids) -> dict:
    """Leaf coverage and rootedness of a graph against a wnid list."""
    wnid_set = {w.strip() for w in wnids}
    missing_leaves = wnid_set - set(get_leaves(G))
    missing_nodes = wnid_set - set(G.nodes)
    num_roots = len(list(get_roots(G)))
    return {
        "ok": not missing_leaves and not missing_nodes and num_roots == 1,
        "missing_leaves": sorted(missing_leaves),
        "missing_nodes": sorted(missing_nodes),
        "num_roots": num_roots,
    }


def test_hierarchy(dataset: str, path: str, wnids=None) -> bool:
    """Check the hierarchy at ``path`` and print the reference's report."""
    if wnids is None:
        from ..assets import get_dataset_wnids

        wnids = get_dataset_wnids(dataset)
    print("==> Reading from {}".format(path))
    report = check_hierarchy(read_graph(path), wnids)
    name = Path(path).stem
    print(f"[{name}] \t leaves missing: {len(report['missing_leaves'])}")
    print(f"[{name}] \t nodes missing: {len(report['missing_nodes'])}")
    if report["num_roots"] == 1:
        Colors.green("Found just 1 root.")
    else:
        Colors.red(f"Found {report['num_roots']} roots. Should be only 1.")
    if report["ok"]:
        Colors.green("==> All checks pass!")
    else:
        Colors.red("==> Test failed")
    return report["ok"]
