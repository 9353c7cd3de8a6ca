"""Plain soft decision rules of NBDT, read from a node-link hierarchy file.

Written from the NBDT paper (arXiv:2004.00221, section 3.2, "soft
inference") and the upstream ``nbdt/model.py``; it shares no code with the
program under test. For an inner node ``n`` with children ``k``:

    node logit   z[n, k] = mean of the class logits over the leaves under k
    child prob   p[n, k] = softmax over k of z[n, :]
    leaf prob    P[c]    = product of p[n, k] along the root -> c path

Classes are indexed by the dataset's wnid list; a node's children are its
outgoing links in file order. Everything is dense f32 on the caller's
device; the products are plain matmuls, so the caller's TF32 switches
decide their precision.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import torch

DATA = Path(__file__).resolve().parent / "data"


class Hierarchy:
    """The tree of one graph file and one wnid list, as host lists."""

    def __init__(self, graph_path, wnids_path):
        graph = json.loads(Path(graph_path).read_text())
        self.labels = {n["id"]: n.get("label", n["id"]) for n in graph["nodes"]}
        self.children: Dict[str, List[str]] = {n["id"]: [] for n in graph["nodes"]}
        parents: Dict[str, int] = {n["id"]: 0 for n in graph["nodes"]}
        for link in graph["links"]:
            self.children[link["source"]].append(link["target"])
            parents[link["target"]] += 1
        roots = [n for n, p in parents.items() if p == 0]
        if len(roots) != 1 or any(p > 1 for p in parents.values()):
            raise ValueError(f"{graph_path}: not a tree (roots {roots[:3]})")
        self.root = roots[0]
        self.wnids = [w.strip() for w in Path(wnids_path).read_text().split() if w.strip()]
        self.class_of = {w: i for i, w in enumerate(self.wnids)}
        self.inner = sorted(n for n, ch in self.children.items() if ch)
        self.leaves_under: Dict[str, List[int]] = {}
        self._collect(self.root)
        # root -> leaf path of each class: [(inner node, child slot), ...]
        self.paths: List[List[Tuple[str, int]]] = [[] for _ in self.wnids]
        self._walk(self.root, [])
        if any(not p for p in self.paths):
            raise ValueError(f"{graph_path}: a class of {wnids_path} is not a leaf")

    def _collect(self, node: str) -> List[int]:
        if not self.children[node]:
            found = [self.class_of[node]] if node in self.class_of else []
        else:
            found = [c for child in self.children[node] for c in self._collect(child)]
        self.leaves_under[node] = found
        return found

    def _walk(self, node: str, path: List[Tuple[str, int]]) -> None:
        if not self.children[node]:
            if node in self.class_of:
                self.paths[self.class_of[node]] = path
            return
        for k, child in enumerate(self.children[node]):
            self._walk(child, path + [(node, k)])

    @property
    def slots(self) -> List[Tuple[str, int]]:
        """Every (inner node, child slot), node-major."""
        return [(n, k) for n in self.inner for k in range(len(self.children[n]))]


def hierarchy(config: dict) -> Hierarchy:
    """The configuration's tree, from the files vendored beside this module."""
    return Hierarchy(DATA / config["tree"]["graph"], DATA / config["tree"]["wnids"])


class SoftRules:
    """Dense matrices of one hierarchy on a device: ``M [S, C]`` (each slot's
    mean over its leaves), ``U [S, C]`` (1 where class c lies under slot s)
    and the slot -> node index, for ``S`` real child slots."""

    def __init__(self, h: Hierarchy, device):
        C, slots = len(h.wnids), h.slots
        node_index = {n: i for i, n in enumerate(h.inner)}
        M = torch.zeros(len(slots), C)
        for s, (n, k) in enumerate(slots):
            under = h.leaves_under[h.children[n][k]]
            M[s, under] = 1.0 / len(under)
        self.h = h
        self.M = M.to(device)
        self.U = (M > 0).float().to(device)
        self.node_of_slot = torch.tensor([node_index[n] for n, _ in slots], device=device)
        self.num_nodes = len(h.inner)
        self.slot_of = {slot: s for s, slot in enumerate(slots)}

    def node_log_probs(self, logits: torch.Tensor) -> torch.Tensor:
        """Per-slot log-probability of each child given its node, ``[B, S]``."""
        z = logits.float() @ self.M.T
        idx = self.node_of_slot.expand_as(z)
        zmax = torch.full((z.shape[0], self.num_nodes), -torch.inf, device=z.device)
        zmax = zmax.scatter_reduce(1, idx, z, "amax")
        e = torch.exp(z - zmax.gather(1, idx))
        total = torch.zeros_like(zmax).scatter_add(1, idx, e)
        return z - zmax.gather(1, idx) - torch.log(total).gather(1, idx)

    def leaf_log_probs(self, logits: torch.Tensor) -> torch.Tensor:
        """``log P[c]`` for every class, ``[B, C]``."""
        return self.node_log_probs(logits) @ self.U

    def probs(self, logits: torch.Tensor) -> torch.Tensor:
        """The soft rules' class probabilities ``P``, ``[B, C]``."""
        return torch.exp(self.leaf_log_probs(logits))

    def node_entropy(self, slot_logp: torch.Tensor) -> torch.Tensor:
        """Entropy in nats of each inner node's child distribution, ``[B, N]``."""
        p = torch.exp(slot_logp)
        idx = self.node_of_slot.expand_as(p)
        return torch.zeros(p.shape[0], self.num_nodes, device=p.device).scatter_add(
            1, idx, -p * slot_logp)

    def decisions(self, logits: torch.Tensor):
        """(probs, paths): per image, the steps root -> argmax leaf as
        ``(node wnid, probability of reaching it from its parent, entropy of
        the parent)``, the root's as ``(root, 1.0, 0.0)``; and the gap between
        the two best leaf log-probabilities, which says how near a tie the
        argmax is."""
        slot_logp = self.node_log_probs(logits)
        leaf = slot_logp @ self.U
        ent = self.node_entropy(slot_logp)
        top2 = leaf.topk(min(2, leaf.shape[1]), dim=1)
        gap = (top2.values[:, 0] - top2.values[:, -1]).cpu()
        slot_logp, ent, best = slot_logp.cpu(), ent.cpu(), top2.indices[:, 0].cpu()
        node_index = {n: i for i, n in enumerate(self.h.inner)}
        paths = []
        for b, c in enumerate(best.tolist()):
            steps = [(self.h.root, 1.0, 0.0)]
            for n, k in self.h.paths[c]:
                p = float(torch.exp(slot_logp[b, self.slot_of[(n, k)]]))
                steps.append((self.h.children[n][k], p, float(ent[b, node_index[n]])))
            paths.append(steps)
        return torch.exp(leaf), paths, gap
