"""Tree runtime: host-side hierarchy and its compilation to static arrays.

Counterpart of ``nbdt_tpu/tree.py``. The Tree is compiled once on the host
into a :class:`TreeArrays` bundle of numpy constants (per-node child
membership, padded child tables, per-leaf path tables). The decision rules
move that bundle to the device once and the per-batch tree math becomes two
matmuls and a masked softmax.

Semantics kept exactly (the tests hold every field equal to the JAX
package's):
  * per-node child order = graph successor insertion order = JSON link order;
  * inode order = sorted by wnid over non-leaf nodes;
  * node child logit = mean of class logits over the child's descendant leaves;
  * leaf distribution = product over the root->leaf path of child softmax
    probabilities.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .assets import get_dataset_wnids
from .hierarchy.digraph import Digraph, get_leaf_to_path, get_leaves, read_graph
from .hierarchy.wnid import get_wnids, wnid_to_name
from .utils import (
    DATASET_TO_NUM_CLASSES,
    dataset_to_default_path_graph,
    dataset_to_default_path_wnids,
    hierarchy_to_path_graph,
)


def dataset_to_dummy_classes(dataset: str) -> List[str]:
    num_classes = DATASET_TO_NUM_CLASSES[dataset]
    return ["f{:08d}".format(i) for i in range(num_classes)]


class Node:
    """A hierarchy node with cached class<->child mappings.

    ``class_index_to_child_index`` maps a global class index to the list of
    child slots it falls under (a singleton for trees);
    ``child_index_to_class_index`` maps a child slot to the global class
    indices of its descendant leaves.
    """

    def __init__(self, tree: "Tree", wnid: str, other_class: bool = False):
        self.tree = tree
        self.wnid = wnid
        self.name = tree.wnid_to_label.get(wnid) or wnid_to_name(wnid)

        self.original_classes = tree.classes
        self.num_original_classes = len(tree.wnids_leaves)

        self.has_other = other_class and not (self.is_root() or self.is_leaf())
        self.num_children = len(self.succ)
        self.num_classes = self.num_children + int(self.has_other)

        (
            self.class_index_to_child_index,
            self.child_index_to_class_index,
        ) = self.build_class_mappings()
        self.classes = self.build_classes()

        self.leaves = list(get_leaves(tree.G, self.wnid))
        self.num_leaves = len(self.leaves)

    @property
    def succ(self) -> List[str]:
        return self.tree.G.succ(self.wnid)

    @property
    def pred(self) -> List[str]:
        return self.tree.G.pred(self.wnid)

    @property
    def children(self) -> List["Node"]:
        return [self.tree.wnid_to_node[wnid] for wnid in self.succ]

    @property
    def parents(self) -> List["Node"]:
        return [self.tree.wnid_to_node[wnid] for wnid in self.pred]

    @property
    def parent(self) -> Optional["Node"]:
        parents = self.parents
        return parents[0] if parents else None

    def is_leaf(self) -> bool:
        return len(self.succ) == 0

    def is_root(self) -> bool:
        return len(self.pred) == 0

    def wnid_to_class_index(self, wnid: str) -> int:
        return self.tree.wnids_leaves.index(wnid)

    def wnid_to_child_index(self, wnid: str) -> int:
        return [child.wnid for child in self.children].index(wnid)

    def build_class_mappings(self):
        if self.is_leaf():
            return {}, {}
        old_to_new: Dict[int, List[int]] = {}
        new_to_old: Dict[int, List[int]] = {}
        for new_index, child in enumerate(self.succ):
            new_to_old.setdefault(new_index, [])
            for leaf in get_leaves(self.tree.G, child):
                old_index = self.tree.wnid_to_class_index.get(leaf)
                if old_index is None:
                    continue
                old_to_new.setdefault(old_index, []).append(new_index)
                new_to_old[new_index].append(old_index)
        if not self.has_other:
            return old_to_new, new_to_old
        new_index = self.num_children
        new_to_old.setdefault(new_index, [])
        for old in range(self.num_original_classes):
            if old not in old_to_new:
                old_to_new.setdefault(old, []).append(new_index)
                new_to_old[new_index].append(old)
        return old_to_new, new_to_old

    def build_classes(self) -> List[str]:
        return [
            ",".join(
                self.original_classes[old]
                for old in old_indices
                if old < len(self.original_classes)
            )
            for _, old_indices in sorted(
                self.child_index_to_class_index.items(), key=lambda t: t[0]
            )
        ]

    @property
    def class_counts(self) -> List[int]:
        """Descendant classes under each child slot, in slot order."""
        return [len(v) for _, v in sorted(self.child_index_to_class_index.items(),
                                          key=lambda t: t[0])]

    @staticmethod
    def dim(nodes: Sequence["Node"]) -> int:
        """Total child slots (the ``other`` slot included) of ``nodes``."""
        return sum(node.num_classes for node in nodes)

    def __repr__(self):
        return f"Node({self.wnid}, name={self.name!r}, children={self.num_children})"


class Tree:
    """In-memory hierarchy and its array compiler."""

    def __init__(
        self,
        dataset: Optional[str],
        path_graph: Optional[str] = None,
        path_wnids: Optional[str] = None,
        classes: Optional[Sequence[str]] = None,
        hierarchy: Optional[str] = None,
        graph: Optional[Digraph] = None,
        wnids_leaves: Optional[Sequence[str]] = None,
    ):
        if dataset and hierarchy and not path_graph:
            path_graph = hierarchy_to_path_graph(dataset, hierarchy)
        if dataset and not path_graph and graph is None:
            path_graph = dataset_to_default_path_graph(dataset)
        if dataset and not path_wnids and wnids_leaves is None:
            path_wnids = dataset_to_default_path_wnids(dataset)
        if dataset and not classes:
            classes = dataset_to_dummy_classes(dataset)

        self._arrays: Optional["TreeArrays"] = None
        self.load_hierarchy(
            dataset, path_graph, path_wnids, classes, graph=graph,
            wnids_leaves=wnids_leaves,
        )

    @classmethod
    def from_graph(
        cls,
        graph: Digraph,
        wnids_leaves: Sequence[str],
        classes: Optional[Sequence[str]] = None,
        dataset: Optional[str] = None,
    ) -> "Tree":
        """Build directly from an in-memory graph (no files)."""
        classes = list(classes) if classes else list(wnids_leaves)
        return cls(dataset, classes=classes, graph=graph, wnids_leaves=wnids_leaves)

    def load_hierarchy(
        self, dataset, path_graph, path_wnids, classes, graph=None, wnids_leaves=None
    ) -> None:
        self.dataset = dataset
        self.path_graph = path_graph
        self.path_wnids = path_wnids
        self.classes = list(classes)
        self.G = graph if graph is not None else read_graph(path_graph)
        if wnids_leaves is not None:
            self.wnids_leaves = list(wnids_leaves)
        elif dataset is not None and (
            path_wnids is None or not os.path.exists(str(path_wnids))
        ):
            self.wnids_leaves = get_dataset_wnids(dataset, path_wnids)
        else:
            self.wnids_leaves = get_wnids(path_wnids)
        self.wnid_to_label = {n: self.G.label(n) for n in self.G.nodes}
        self.wnid_to_class = dict(zip(self.wnids_leaves, self.classes))
        self.wnid_to_class_index = {w: i for i, w in enumerate(self.wnids_leaves)}
        self.wnid_to_node = {wnid: Node(self, wnid) for wnid in self.G}
        self.nodes = [self.wnid_to_node[w] for w in sorted(self.wnid_to_node)]
        self.inodes = [n for n in self.nodes if not n.is_leaf()]
        self.leaves = [self.wnid_to_node[w] for w in self.wnids_leaves]
        self._arrays = None

    @classmethod
    def create_from_args(cls, args, classes=None) -> "Tree":
        """A tree from a parsed namespace's ``dataset``, ``path_graph``,
        ``path_wnids`` and ``hierarchy``."""
        return cls(args.dataset, args.path_graph, args.path_wnids, classes=classes,
                   hierarchy=args.hierarchy)

    @property
    def root(self) -> Node:
        for node in self.inodes:
            if node.is_root():
                return node
        raise RuntimeError("Tree should always have a root")

    def get_leaf_to_steps(self) -> Dict[str, List[dict]]:
        """Per-leaf root->leaf step dicts."""
        leaf_to_path = get_leaf_to_path(self.G)
        leaf_to_steps = {}
        for leaf in self.wnids_leaves:
            next_indices = [index for index, _ in leaf_to_path[leaf][1:]] + [-1]
            leaf_to_steps[leaf] = [
                {
                    "node": self.wnid_to_node[wnid],
                    "name": self.wnid_to_node[wnid].name,
                    "next_index": next_index,
                }
                for next_index, (_, wnid) in zip(next_indices, leaf_to_path[leaf])
            ]
        return leaf_to_steps

    def update_from_model(self, model, arch, dataset, classes=None, path_wnids=None,
                          path_graph=None, force: bool = True) -> None:
        """Regenerate the induced hierarchy from a live model's classifier
        (``model`` an ``nn.Module``; SoftTreeLoss's refresh), write it to
        ``path_graph`` and reload this tree from it. Regenerating is the
        point, so ``force`` defaults to True."""
        from .hierarchy.generate import generate_hierarchy

        path_graph = generate_hierarchy(dataset=dataset, method="induced", arch=arch,
                                        model=model, path=path_graph,
                                        wnids=self.wnids_leaves, force=force)
        self.load_hierarchy(dataset=dataset, path_graph=path_graph,
                            path_wnids=path_wnids or self.path_wnids,
                            classes=classes or self.classes, wnids_leaves=self.wnids_leaves)

    def visualize(self, path_html: str, dataset: Optional[str] = None, **kwargs) -> str:
        """Write this hierarchy's HTML (``hierarchy.vis.generate_hierarchy_vis_from``)."""
        from .hierarchy.vis import generate_hierarchy_vis_from

        return generate_hierarchy_vis_from(self.G, dataset=dataset or self.dataset,
                                           path_html=path_html, **kwargs)

    @property
    def arrays(self) -> "TreeArrays":
        if self._arrays is None:
            self._arrays = TreeArrays.compile(self)
        return self._arrays


@dataclass(frozen=True)
class TreeArrays:
    """Static numpy encoding of a Tree.

    Shapes: C = num classes (leaves), N = num inner nodes (in ``tree.inodes``
    order, i.e. sorted by wnid), K = max children of any inner node, D = max
    root->leaf path length in inner-node steps.
    """

    num_classes: int
    num_inodes: int
    max_children: int
    max_depth: int

    # membership[n, k, c] = 1/|leaves(child k of node n)| if class c descends
    # from that child, else 0: node child logits are logits @ membership[n].T.
    membership: np.ndarray  # float32 [N, K, C]
    under: np.ndarray  # float32 [N, K, C], 1 where class c is under slot (n, k)
    child_mask: np.ndarray  # bool [N, K]
    num_children: np.ndarray  # int32 [N]
    # target_child[n, c] = child slot of class c at node n, -1 if c is not under n
    target_child: np.ndarray  # int32 [N, C]
    # child_next[n, k]: inode index of child k if it is an inner node, N + class
    # index if it is a leaf, -1 for padding (drives the hard walk)
    child_next: np.ndarray  # int32 [N, K]
    root_inode: int
    # per-leaf root->leaf path: inode and chosen child slot per step, -1 padded
    leaf_path_nodes: np.ndarray  # int32 [C, D]
    leaf_path_children: np.ndarray  # int32 [C, D]
    leaf_depth: np.ndarray  # int32 [C]

    wnids_inodes: tuple = field(default=())
    wnids_leaves: tuple = field(default=())
    # True when any graph node has several parents (multi-path DAGs): the
    # closed-form hard traversal assumes unique root paths and must take the
    # literal walk instead.
    is_multipath: bool = field(default=False)

    @staticmethod
    def compile(tree: Tree) -> "TreeArrays":
        C = len(tree.wnids_leaves)
        inodes = tree.inodes
        N = len(inodes)
        assert N > 0, "Tree has no inner nodes"
        K = max(n.num_classes for n in inodes)
        wnid_to_inode = {n.wnid: i for i, n in enumerate(inodes)}

        membership = np.zeros((N, K, C), dtype=np.float32)
        under = np.zeros((N, K, C), dtype=np.float32)
        child_mask = np.zeros((N, K), dtype=bool)
        num_children = np.zeros((N,), dtype=np.int32)
        target_child = np.full((N, C), -1, dtype=np.int32)
        child_next = np.full((N, K), -1, dtype=np.int32)

        for i, node in enumerate(inodes):
            num_children[i] = node.num_classes
            for k in range(node.num_classes):
                child_mask[i, k] = True
                old = node.child_index_to_class_index.get(k, [])
                if old:
                    membership[i, k, old] = 1.0 / len(old)
                    under[i, k, old] = 1.0
                    # First child wins when a class sits under several
                    # children (multi-path graphs), as the hard loss targets
                    # class_index_to_child_index[t][0].
                    old_arr = np.asarray(old)
                    unset = target_child[i, old_arr] < 0
                    target_child[i, old_arr[unset]] = k
                if k < node.num_children:
                    child_wnid = node.succ[k]
                    if child_wnid in wnid_to_inode:
                        child_next[i, k] = wnid_to_inode[child_wnid]
                    else:
                        ci = tree.wnid_to_class_index.get(child_wnid)
                        if ci is None:
                            raise ValueError(
                                f"Graph leaf {child_wnid!r} is not in the "
                                f"class wnid list ({C} classes); the arrays "
                                "cannot represent a leaf with no class. "
                                "Regenerate the hierarchy for this class "
                                "list or pass matching wnids."
                            )
                        child_next[i, k] = N + ci

        # leaf_to_path includes the root and the leaf; the inner-node steps
        # are all entries except the final leaf.
        leaf_to_path = get_leaf_to_path(tree.G)
        D = max(max(len(leaf_to_path[w]) - 1 for w in tree.wnids_leaves), 1)
        leaf_path_nodes = np.full((C, D), -1, dtype=np.int32)
        leaf_path_children = np.full((C, D), -1, dtype=np.int32)
        leaf_depth = np.zeros((C,), dtype=np.int32)
        for c, wnid in enumerate(tree.wnids_leaves):
            path = leaf_to_path[wnid]
            steps = path[:-1]
            leaf_depth[c] = len(steps)
            for d, (_, node_wnid) in enumerate(steps):
                leaf_path_nodes[c, d] = wnid_to_inode[node_wnid]
                leaf_path_children[c, d] = path[d + 1][0]

        return TreeArrays(
            num_classes=C,
            num_inodes=N,
            max_children=K,
            max_depth=D,
            membership=membership,
            under=under,
            child_mask=child_mask,
            num_children=num_children,
            target_child=target_child,
            child_next=child_next,
            root_inode=wnid_to_inode[tree.root.wnid],
            leaf_path_nodes=leaf_path_nodes,
            leaf_path_children=leaf_path_children,
            leaf_depth=leaf_depth,
            wnids_inodes=tuple(n.wnid for n in inodes),
            wnids_leaves=tuple(tree.wnids_leaves),
            is_multipath=any(len(tree.G.pred(n)) > 1 for n in tree.G.nodes),
        )
