"""A minimal insertion-ordered directed graph with node-link JSON IO.

Counterpart of ``nbdt_tpu/hierarchy/digraph.py``. Insertion order is
load-bearing: a node's child order is its ``succ`` insertion order, which is
the JSON ``links`` array order, and decision-path parity with the JAX package
and the reference depends on it. So ``succ``/``pred`` are plain ordered dicts
keyed by edge insertion.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional, Tuple

from ..utils import makeparentdirs


class Digraph:
    def __init__(self):
        # node -> attr dict; insertion ordered
        self._nodes: Dict[str, dict] = {}
        # node -> {child: None} / {parent: None}; insertion ordered sets
        self._succ: Dict[str, Dict[str, None]] = {}
        self._pred: Dict[str, Dict[str, None]] = {}

    def add_node(self, node: str, **attrs) -> None:
        if node not in self._nodes:
            self._nodes[node] = {}
            self._succ[node] = {}
            self._pred[node] = {}
        self._nodes[node].update(attrs)

    def add_edge(self, parent: str, child: str) -> None:
        self.add_node(parent)
        self.add_node(child)
        self._succ[parent][child] = None
        self._pred[child][parent] = None

    def remove_node(self, node: str) -> None:
        """Unlink every edge into and out of ``node``, then drop it."""
        for child in list(self._succ[node]):
            del self._pred[child][node]
        for parent in list(self._pred[node]):
            del self._succ[parent][node]
        del self._nodes[node]
        del self._succ[node]
        del self._pred[node]

    def set_label(self, node: str, label: str) -> None:
        self.add_node(node, label=label)

    @property
    def nodes(self) -> List[str]:
        return list(self._nodes)

    def __contains__(self, node: str) -> bool:
        return node in self._nodes

    def __iter__(self) -> Iterator[str]:
        return iter(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def attrs(self, node: str) -> dict:
        return self._nodes[node]

    def label(self, node: str) -> str:
        return self._nodes[node].get("label", "")

    def succ(self, node: str) -> List[str]:
        return list(self._succ[node])

    def pred(self, node: str) -> List[str]:
        return list(self._pred[node])

    def edges(self) -> List[Tuple[str, str]]:
        return [(u, v) for u in self._nodes for v in self._succ[u]]

    def is_leaf(self, node: str) -> bool:
        return len(self._succ[node]) == 0

    def descendants(self, node: str) -> List[str]:
        """All nodes reachable from ``node`` (exclusive), DFS preorder."""
        seen, order, stack = set(), [], list(reversed(self.succ(node)))
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            order.append(cur)
            stack.extend(reversed(self.succ(cur)))
        return order

    def contracted(self, keep: str, remove: str) -> "Digraph":
        """A copy with ``remove`` merged into ``keep``, as networkx's
        ``contracted_nodes(G, keep, remove, self_loops=False)`` makes it:
        ``keep``'s attributes win and ``remove``'s go into its
        ``contraction`` dict (nearest first over repeated contractions); the
        surviving edges keep their order and ``remove``'s edges, re-pointed
        at ``keep``, come after them, in-edges first. Child order is
        decision-path order, so this order matters."""
        H = Digraph()
        for node, attrs in self._nodes.items():
            if node != remove:
                H.add_node(node, **attrs)
        contraction = dict(self._nodes[keep].get("contraction") or {})
        contraction[remove] = {k: v for k, v in self._nodes[remove].items() if k != "contraction"}
        if "contraction" in self._nodes[remove]:
            contraction[remove]["contraction"] = self._nodes[remove]["contraction"]
        H.add_node(keep, contraction=contraction)
        for u in self._nodes:
            if u == remove:
                continue
            for v in self._succ[u]:
                if v != remove:
                    H.add_edge(u, v)
        for u in self._pred[remove]:
            if u != keep:
                H.add_edge(u, keep)
        for v in self._succ[remove]:
            if v != keep:
                H.add_edge(keep, v)
        return H


def get_leaves(G: Digraph, root: Optional[str] = None) -> Iterator[str]:
    nodes = G.nodes if root is None else G.descendants(root) + [root]
    for node in nodes:
        if G.is_leaf(node):
            yield node


def get_roots(G: Digraph) -> Iterator[str]:
    for node in G.nodes:
        if len(G.pred(node)) == 0:
            yield node


def get_root(G: Digraph) -> str:
    roots = list(get_roots(G))
    assert len(roots) == 1, f"Multiple ({len(roots)}) roots found"
    return roots[0]


def get_depth(G: Digraph) -> int:
    def _depth(node: str) -> int:
        children = G.succ(node)
        if not children:
            return 1
        return max(_depth(child) for child in children) + 1

    return max(_depth(root) for root in get_roots(G))


def get_leaf_to_path(G: Digraph) -> Dict[str, List[Tuple[int, str]]]:
    """BFS from each root; per-leaf list of (child_index, node) pairs.

    child_index is the node's index within its parent's children; the
    root's index is 0. On a DAG the last BFS visit of a leaf wins.
    """
    leaf_to_path: Dict[str, List[Tuple[int, str]]] = {}
    for root in get_roots(G):
        frontier: List[Tuple[str, int, list]] = [(root, 0, [])]
        while frontier:
            node, child_index, path = frontier.pop(0)
            path = path + [(child_index, node)]
            if G.is_leaf(node):
                leaf_to_path[node] = path
                continue
            frontier.extend((child, i, path) for i, child in enumerate(G.succ(node)))
    return leaf_to_path


def node_link_data(G: Digraph) -> dict:
    return {
        "directed": True,
        "multigraph": False,
        "graph": {},
        "nodes": [{**G.attrs(node), "id": node} for node in G.nodes],
        "links": [{"source": u, "target": v} for (u, v) in G.edges()],
    }


def node_link_graph(data: dict) -> Digraph:
    G = Digraph()
    for entry in data.get("nodes", []):
        attrs = {k: v for k, v in entry.items() if k != "id"}
        G.add_node(entry["id"], **attrs)
    for link in data.get("links", []):
        G.add_edge(link["source"], link["target"])
    return G


def write_graph(G: Digraph, path) -> None:
    """The node-link JSON of the reference's hierarchy files."""
    makeparentdirs(path)
    with open(str(path), "w") as f:
        json.dump(node_link_data(G), f)


def read_graph(path) -> Digraph:
    with open(str(path)) as f:
        return node_link_graph(json.load(f))
