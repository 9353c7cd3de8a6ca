"""The induced hierarchy builder and the pruning pass.

Counterpart of the induced half of ``nbdt_tpu/hierarchy/build.py``. The
rows of the network's final classifier ("class centers") are clustered by
ward agglomeration; each merge becomes a parent node, named by the deepest
unused common WordNet hypernym of its children, or a ``FakeSynset`` where
no corpus can name it (always, offline). Centers come in as a numpy array;
``generate.py`` takes them from a torch module or a state dict.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .cluster import ward_children
from .digraph import Digraph, get_roots
from .wnid import FakeSynset, synset_to_name, synset_to_wnid, wnid_to_synset, wordnet_available


def set_node_label(G: Digraph, synset) -> None:
    G.set_label(synset_to_wnid(synset), synset_to_name(synset))


def build_induced_graph(
    wnids: Sequence[str],
    centers: np.ndarray,
    branching_factor: int = 2,
    dataset: str = "CIFAR10",
) -> Digraph:
    """The hierarchy induced from class centers ``[num_classes, dim]``, rows
    in ``wnids`` order: one parent per ward merge, so a single root."""
    num_classes = len(wnids)
    centers = np.asarray(centers)
    if centers.ndim != 2 or centers.shape[0] != num_classes:
        raise ValueError(f"centers {centers.shape} does not match {num_classes} classes for "
                         f"dataset {dataset}")

    G = Digraph()
    for wnid in wnids:
        G.add_node(wnid)
        set_node_label(G, wnid_to_synset(wnid))

    index_to_wnid = {}
    for index, pair in enumerate(map(tuple, ward_children(centers))):
        child_wnids = [wnids[c] if c < num_classes else index_to_wnid[c - num_classes]
                       for c in pair]
        parent = get_wordnet_meaning(G, [wnid_to_synset(w) for w in child_wnids])
        parent_wnid = synset_to_wnid(parent)
        G.add_node(parent_wnid)
        set_node_label(G, parent)
        index_to_wnid[index] = parent_wnid
        for child_wnid in child_wnids:
            G.add_edge(parent_wnid, child_wnid)

    roots = list(get_roots(G))
    if len(roots) != 1:
        raise RuntimeError(f"Expected single root, got {roots}")
    return G


def prune_single_successor_nodes(G: Digraph) -> Digraph:
    for node in G.nodes:
        if node in G and len(G.succ(node)) == 1:
            G = G.contracted(G.succ(node)[0], node)
    return G


# ---------------------------------------------------------------------------
# WordNet naming of generated parents
# ---------------------------------------------------------------------------


def get_wordnet_meaning(G: Digraph, synsets):
    hypernyms = get_common_hypernyms(synsets)
    candidate = pick_unseen_hypernym(G, hypernyms) if hypernyms else None
    if candidate is None:
        return FakeSynset.create_from_offset(len(G.nodes))
    return candidate


def deepest_synset(synsets):
    return max(synsets, key=lambda synset: synset.max_depth())


def get_common_hypernyms(synsets):
    if not wordnet_available():
        return set()
    if any(isinstance(s, FakeSynset) or s.pos() == "f" for s in synsets):
        return set()
    common = set(synsets[0].common_hypernyms(synsets[1]))
    for synset in synsets[2:]:
        common &= set(synsets[0].common_hypernyms(synset))
    return common


def pick_unseen_hypernym(G: Digraph, common_hypernyms):
    assert len(common_hypernyms) > 0
    candidate = deepest_synset(common_hypernyms)
    wnid = synset_to_wnid(candidate)
    while common_hypernyms and wnid in G:
        common_hypernyms -= {candidate}
        if not common_hypernyms:
            return None
        candidate = deepest_synset(common_hypernyms)
        wnid = synset_to_wnid(candidate)
    return candidate
