"""Hierarchy builders (induced, random, WordNet), pruning and augmenting.

Counterpart of ``nbdt_tpu/hierarchy/build.py``. The induced builder
clusters the rows of the network's final classifier ("class centers") by
ward agglomeration; each merge becomes a parent node, named by the deepest
unused common WordNet hypernym of its children, or a ``FakeSynset`` where
no corpus can name it. Centers come in as a numpy array; ``generate.py``
takes them from a torch module, a state dict or a ``.pth``. The random
builder groups shuffled leaves bottom-up; the WordNet builder walks each
leaf's hypernyms and needs a corpus (NLTK's, or a mini-corpus). The random
draws are Python's ``random`` module seeded as the JAX package seeds it, so
both packages write the same graphs.
"""

from __future__ import annotations

import random
from typing import List, Sequence

import numpy as np

from .cluster import ward_children
from .digraph import Digraph, get_root, get_roots
from .wnid import FakeSynset, synset_to_name, synset_to_wnid, wnid_to_synset, wordnet_available


def set_node_label(G: Digraph, synset) -> None:
    G.set_label(synset_to_wnid(synset), synset_to_name(synset))


def set_random_node_label(G: Digraph, node: str) -> None:
    G.set_label(node, "")


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


def build_random_graph(wnids: Sequence[str], seed: int = 0, branching_factor: int = 2
                       ) -> Digraph:
    """Leaves shuffled (``seed >= 0``) and grouped bottom-up by
    ``branching_factor``; generated nodes are numbered root-down."""
    wnids = list(wnids)
    random.seed(seed)
    G = Digraph()
    if seed >= 0:
        random.shuffle(wnids)

    remaining: list = wnids
    while len(remaining) > 1:
        current, remaining = remaining, []
        while current:
            nodes, current = current[:branching_factor], current[branching_factor:]
            remaining.append(nodes)

    G.add_node("0")
    set_random_node_label(G, "0")
    queue = [(remaining[0], "0")]
    i = 1
    while queue:
        group, parent = queue.pop(0)
        if len(group) == 1:
            if isinstance(group[0], str):
                G.add_node(group[0])
                set_node_label(G, wnid_to_synset(group[0]))
                G.add_edge(parent, group[0])
            else:
                queue.append((group[0], parent))
            continue
        for candidate in group:
            is_leaf = not isinstance(candidate, list)
            wnid = candidate if is_leaf else str(i)
            G.add_node(wnid)
            if is_leaf:
                set_node_label(G, wnid_to_synset(wnid))
            else:
                set_random_node_label(G, wnid)
            G.add_edge(parent, wnid)
            i += 1
            if not is_leaf:
                queue.append((candidate, wnid))
    return G


def build_minimal_wordnet_graph(wnids: Sequence[str], multi_path: bool = False) -> Digraph:
    """Each leaf and its WordNet hypernym chain (the first hypernym of each
    synset, or all of them with ``multi_path``), with the reference's
    re-parenting of 'girl'. Needs a corpus: NLTK's or a mini-corpus."""
    if not wordnet_available():
        raise RuntimeError(
            "Building a WordNet hierarchy needs a WordNet corpus: the NLTK corpus where it "
            "is installed, or a mini-corpus (install_mini_corpus, --mini-corpus) derived from "
            "a vendored graph-wordnet.json; or use method='induced'/'random'.")
    G = Digraph()
    for wnid in wnids:
        G.add_node(wnid)
        synset = wnid_to_synset(wnid)
        set_node_label(G, synset)

        if wnid == "n10129825":  # 'girl': re-parent away from 'woman'
            if not multi_path:
                G.add_edge("n09624168", "n10129825")  # child of 'male'
            else:
                G.add_edge("n09619168", "n10129825")
            G.add_edge("n09619168", "n10129825")  # child of 'female'
            continue

        hypernyms = [synset]
        while hypernyms:
            current = hypernyms.pop(0)
            set_node_label(G, current)
            for hypernym in current.hypernyms():
                G.add_edge(synset_to_wnid(hypernym), synset_to_wnid(current))
                hypernyms.append(hypernym)
                if not multi_path:
                    break

        children = G.succ(wnid)
        if children:
            raise ValueError(f"Node {wnid} ({synset.name()}) is not a leaf. "
                             f"Children: {children}")
    return G


def prune_single_successor_nodes(G: Digraph) -> Digraph:
    for node in G.nodes:
        if node in G and len(G.succ(node)) == 1:
            G = G.contracted(G.succ(node)[0], node)
    return G


def augment_graph(G: Digraph, extra: float, allow_imaginary: bool = False, seed: int = 0,
                  max_retries: int = 10000):
    """Adds ``extra`` percent more nodes under the root, each the parent of
    2-4 random nodes and named by their deepest unused common hypernym;
    returns ``(G, n_extra, n_imaginary)`` (imaginary: a ``FakeSynset``
    parent, kept only with ``allow_imaginary``)."""
    n_extra = int(extra / 100.0 * len(G.nodes))
    random.seed(seed)

    n_imaginary = 0
    for i in range(n_extra):
        candidate, is_imaginary_synset, children = get_new_node(G)
        if not is_imaginary_synset or allow_imaginary:
            add_node_to_graph(G, candidate, children)
            n_imaginary += is_imaginary_synset
            continue
        if n_imaginary > 0:
            return G, i, n_imaginary
        retries, is_imaginary_synset = 0, True
        while is_imaginary_synset:
            candidate, is_imaginary_synset, children = get_new_node(G)
            retries += 1
            if retries > max_retries:
                print(f"Exceeded max retries ({max_retries})")
                return G, i, n_imaginary
        add_node_to_graph(G, candidate, children)
    return G, n_extra, n_imaginary


def get_new_node(G: Digraph):
    root = get_root(G)
    nodes = [n for n in G.nodes if n is not root and not n.startswith("f")]
    children = get_new_adjacency(G, nodes)
    candidate = get_wordnet_meaning(G, [wnid_to_synset(wnid) for wnid in children])
    return candidate, candidate.pos() == "f", children


def add_node_to_graph(G: Digraph, candidate, children) -> None:
    root = get_root(G)
    wnid = synset_to_wnid(candidate)
    G.add_node(wnid)
    set_node_label(G, candidate)
    for child in children:
        G.add_edge(wnid, child)
    G.add_edge(root, wnid)


def get_new_adjacency(G: Digraph, nodes: List[str]):
    """2-4 random nodes that are not already some node's children."""
    adjacency = set(tuple(G.succ(n)) for n in G.nodes)
    children = next(iter(adjacency))
    while children in adjacency:
        children = tuple(random.sample(nodes, k=random.randint(2, 4)))
    return children


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
