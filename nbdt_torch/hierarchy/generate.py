"""Classifier probe, class centers, graph file names and the induced
hierarchy's generation.

Counterpart of ``nbdt_tpu/hierarchy/generate.py`` for ``method="induced"``:
centers are the rows of a classifier, taken from a torch module (the first
``nn.Linear`` among :data:`CLASSIFIER_NAMES`), a state dict, or given as an
array; the graph is induced, pruned and written as the reference's
node-link JSON.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch.nn as nn

from ..utils import ASSETS_ROOT, Colors
from .build import build_induced_graph, prune_single_successor_nodes
from .digraph import Digraph, get_depth, write_graph

# The JAX package's probe order, then torchvision's ViT classifier.
CLASSIFIER_NAMES = ("linear", "fc", "classifier", "head", "output", "heads.head")

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


def resolve_centers(centers=None, state_dict=None, model: Optional[nn.Module] = None
                    ) -> np.ndarray:
    """Class centers ``[C, D]`` from whichever source was given."""
    if centers is not None:
        return np.asarray(centers)
    if state_dict is not None:
        fc = get_centers_from_state_dict(state_dict)
        if fc is None:
            raise ValueError(f"No FC key found in state dict: {list(state_dict)[:20]}")
        return fc
    if model is not None:
        kernel, _ = get_classifier_from_module(model)
        if kernel is None:
            raise ValueError(
                f"A model was given but it has no nn.Linear named one of {CLASSIFIER_NAMES}; "
                f"pass centers= directly. Model type: {type(model).__name__}")
        return kernel.T
    raise ValueError("Need one of `centers`, `state_dict`, `model` to induce a hierarchy.")


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


def generate_hierarchy(
    dataset: str,
    method: str = "induced",
    branching_factor: int = 2,
    no_prune: bool = False,
    fname: str = "",
    path: str = "",
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
    """Induce, prune and write a hierarchy; returns the JSON path, which is
    ``path`` or ``<hierarchies_root>/<dataset>/<graph fname>.json``. Only
    ``method="induced"`` is ported; ``checkpoint`` only names the file. A
    file among the JAX package's vendored hierarchies is overwritten only
    with ``force``."""
    if method != "induced":
        raise NotImplementedError(
            f'method "{method}" is not ported yet (ROADMAP A9); the port induces hierarchies')
    if wnids is None:
        from ..assets import get_dataset_wnids

        wnids = get_dataset_wnids(dataset)
    G = build_induced_graph(wnids, resolve_centers(centers, state_dict, model),
                            branching_factor=branching_factor, dataset=dataset)
    print_graph_stats(G, "matched")
    assert_all_wnids_in_graph(G, wnids)
    if not no_prune:
        G = prune_single_successor_nodes(G)
        print_graph_stats(G, "pruned")
        assert_all_wnids_in_graph(G, wnids)

    if not path:
        name = generate_graph_fname(method=method, branching_factor=branching_factor,
                                    no_prune=no_prune, fname=fname,
                                    induced_linkage=induced_linkage,
                                    induced_affinity=induced_affinity, checkpoint=checkpoint,
                                    arch=arch)
        root = hierarchies_root or os.path.join(ASSETS_ROOT, "hierarchies")
        path = os.path.join(root, dataset, f"{name}.json")
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
