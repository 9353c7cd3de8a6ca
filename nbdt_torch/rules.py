"""Embedded decision rules: the NBDT inference core in plain PyTorch.

Counterpart of ``nbdt_tpu/rules.py``. Both rules are closed-form tensor
programs over the static :class:`~nbdt_torch.tree.TreeArrays` constants:

  soft:  node_logits = logits @ M.T          (one [B,C]x[C,N*K] matmul)
         log-softmax per node (masked)
         leaf_logp = logp @ U                (one [B,N*K]x[N*K,C] matmul)
         class_probs = exp(leaf_logp)        (the raw path-probability product)

  hard:  per-node argmax, then the closed-form walk (one matmul), or the
         literal D-step walk on multi-path graphs.

Node decisions are exact f32: the node-logit and path-sum matmuls run under
:func:`exact_f32` in the forward and in the backward (:func:`exact_matmul`),
so a caller that turned TF32 on for its backbone does not reach them, as
JAX's ``Precision.HIGHEST`` covers the transposed products too. Compiled and
exported programs get the same guarantee from their callers
(:mod:`nbdt_torch.serving`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .tree import Tree, TreeArrays
from .utils import resolve_device

NEG_INF = -1e30  # large-finite, avoids inf-inf NaNs in masked softmax


@contextlib.contextmanager
def exact_f32():
    """Run f32 matmuls in full f32 (no TF32, no reduced-precision CPU path).
    The setting is process-global, so it is restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class _ExactMatmul(torch.autograd.Function):
    """``a @ b`` under :func:`exact_f32` in both passes: autograd runs the
    backward later, outside any context the forward opened."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with exact_f32():
            return a @ b

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        ga = gb = None
        with exact_f32():
            if ctx.needs_input_grad[0]:
                ga = grad @ b.T
            if ctx.needs_input_grad[1]:
                gb = a.T @ grad
        return ga, gb


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-d f32 ``a @ b`` in full f32, forward and backward.

    While ``torch.compile`` or ``torch.export`` traces it, this is a plain
    ``a @ b``: a traced graph carries no matmul precision (switching it
    would cut the graph in pieces, and an exported program would not keep
    the switch). The caller of a compiled or exported program holds
    :func:`exact_f32` around the whole call instead, as
    :func:`nbdt_torch.serving.aot_compile` and
    :func:`~nbdt_torch.serving.load_serving` do."""
    if torch.compiler.is_compiling():
        return a @ b
    return _ExactMatmul.apply(a, b)


class DeviceTreeArrays(NamedTuple):
    """Device-resident tree constants (see TreeArrays for shapes)."""

    membership: torch.Tensor  # [N, K, C] f32
    under: torch.Tensor  # [N, K, C] f32
    child_mask: torch.Tensor  # [N, K] bool
    target_child: torch.Tensor  # [N, C] int64
    child_next: torch.Tensor  # [N, K] int64
    leaf_path_nodes: torch.Tensor  # [C, D] int64
    leaf_path_children: torch.Tensor  # [C, D] int64
    root_inode: int
    num_inodes: int
    num_classes: int
    max_children: int
    max_depth: int
    is_multipath: bool = False


def to_device_tree(ta: TreeArrays, device="cuda") -> DeviceTreeArrays:
    device = resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return DeviceTreeArrays(
        membership=put(ta.membership, torch.float32),
        under=put(ta.under, torch.float32),
        child_mask=put(ta.child_mask, torch.bool),
        target_child=put(ta.target_child, torch.int64),
        child_next=put(ta.child_next, torch.int64),
        leaf_path_nodes=put(ta.leaf_path_nodes, torch.int64),
        leaf_path_children=put(ta.leaf_path_children, torch.int64),
        root_inode=int(ta.root_inode),
        num_inodes=int(ta.num_inodes),
        num_classes=int(ta.num_classes),
        max_children=int(ta.max_children),
        max_depth=int(ta.max_depth),
        is_multipath=bool(ta.is_multipath),
    )


# ---------------------------------------------------------------------------
# Node-level outputs
# ---------------------------------------------------------------------------


def get_node_logits(logits: torch.Tensor, jt: DeviceTreeArrays) -> torch.Tensor:
    """Per-node child logits [B, N, K]: the mean of class logits over each
    child's descendant leaves, as one matmul against the membership matrix."""
    B = logits.shape[0]
    N, K, C = jt.membership.shape
    nl = exact_matmul(logits.float(), jt.membership.reshape(N * K, C).T)
    return nl.reshape(B, N, K)


def masked_log_softmax(node_logits: torch.Tensor, child_mask: torch.Tensor):
    """Log-softmax over the child axis, padding slots excluded.

    Returns (log_probs, probs); padded slots get log_prob=NEG_INF, prob=0.
    """
    mask = child_mask[None]
    masked = torch.where(mask, node_logits, NEG_INF)
    lse = torch.logsumexp(masked, dim=-1, keepdim=True)
    log_probs = torch.where(mask, masked - lse, NEG_INF)
    probs = torch.where(mask, torch.exp(log_probs), 0.0)
    return log_probs, probs


def node_entropy(probs: torch.Tensor, child_mask: torch.Tensor) -> torch.Tensor:
    """Per-node categorical entropy in nats [B, N]."""
    p = torch.where(child_mask[None], probs, 0.0)
    plogp = torch.where(p > 0, p * torch.log(p), 0.0)
    return -plogp.sum(-1)


class NodeOutputs(NamedTuple):
    logits: torch.Tensor  # [B, N, K]
    log_probs: torch.Tensor  # [B, N, K]
    probs: torch.Tensor  # [B, N, K]
    preds: torch.Tensor  # [B, N] argmax child per node
    entropy: torch.Tensor  # [B, N]


def get_all_node_outputs(logits: torch.Tensor, jt: DeviceTreeArrays) -> NodeOutputs:
    nl = get_node_logits(logits, jt)
    log_probs, probs = masked_log_softmax(nl, jt.child_mask)
    preds = torch.where(jt.child_mask[None], nl, NEG_INF).argmax(-1)
    ent = node_entropy(probs, jt.child_mask)
    return NodeOutputs(nl, log_probs, probs, preds, ent)


# ---------------------------------------------------------------------------
# Soft traversal
# ---------------------------------------------------------------------------


def soft_leaf_log_probs(log_probs: torch.Tensor, jt: DeviceTreeArrays) -> torch.Tensor:
    """leaf_logp[b, c] = sum of chosen-child log-probs down c's path.

    On a multi-path graph, every slot containing c contributes, as in the
    JAX package (a strict extension of the reference's domain)."""
    B = log_probs.shape[0]
    N, K, C = jt.under.shape
    safe = torch.where(jt.child_mask[None], log_probs, 0.0)
    return exact_matmul(safe.reshape(B, N * K), jt.under.reshape(N * K, C))


def soft_forward(logits: torch.Tensor, jt: DeviceTreeArrays) -> torch.Tensor:
    """Leaf distribution [B, C]: the raw product of path probabilities (not
    normalized), as the reference's soft rules return it."""
    outs = get_all_node_outputs(logits, jt)
    return torch.exp(soft_leaf_log_probs(outs.log_probs, jt))


def soft_outputs(logits: torch.Tensor, jt: DeviceTreeArrays):
    outs = get_all_node_outputs(logits, jt)
    leaf_logp = soft_leaf_log_probs(outs.log_probs, jt)
    return {
        "node_logits": outs.logits,
        "node_log_probs": outs.log_probs,
        "node_probs": outs.probs,
        "node_preds": outs.preds,
        "node_entropy": outs.entropy,
        "leaf_log_probs": leaf_logp,
        "class_probs": torch.exp(leaf_logp),
        "preds": leaf_logp.argmax(-1),
    }


# ---------------------------------------------------------------------------
# Hard traversal
# ---------------------------------------------------------------------------


def hard_traverse(node_preds: torch.Tensor, jt: DeviceTreeArrays) -> torch.Tensor:
    """Closed-form root->leaf argmax walk; returns the predicted class [B].

    Leaf c is reached iff every inner node on its path argmaxes onto c's
    path child, i.e. the count of agreeing path slots equals c's depth, so
    argmax(count - path_len) is the prediction. Multi-path graphs break the
    unique-path assumption and take the literal walk.
    """
    if jt.is_multipath:
        return hard_traverse_scan(node_preds, jt)
    B = node_preds.shape[0]
    N, K, C = jt.under.shape
    u = (jt.under.reshape(N * K, C) > 0).float()
    path_len = u.sum(0)
    chosen = F.one_hot(node_preds, K).float().reshape(B, N * K)
    with exact_f32():
        count = chosen @ u
    return (count - path_len[None]).argmax(-1)


def hard_traverse_scan(node_preds: torch.Tensor, jt: DeviceTreeArrays) -> torch.Tensor:
    """The literal walk, max_depth gather steps. The cursor is an inner-node
    index below N and N + class index at a leaf."""
    B = node_preds.shape[0]
    N, K = jt.child_next.shape
    child_next_flat = jt.child_next.reshape(-1)
    cur = torch.full((B,), jt.root_inode, dtype=torch.int64, device=node_preds.device)
    for _ in range(jt.max_depth):
        n = cur.clamp(0, N - 1)
        k = node_preds.gather(1, n[:, None])[:, 0]
        cur = torch.where(cur < N, child_next_flat[n * K + k], cur)
    return cur - N


def hard_forward(logits: torch.Tensor, jt: DeviceTreeArrays) -> torch.Tensor:
    """One-hot logits of the hard prediction [B, C]."""
    outs = get_all_node_outputs(logits, jt)
    return F.one_hot(hard_traverse(outs.preds, jt), jt.num_classes).float()


def hard_outputs(logits: torch.Tensor, jt: DeviceTreeArrays):
    outs = get_all_node_outputs(logits, jt)
    preds = hard_traverse(outs.preds, jt)
    return {
        "node_logits": outs.logits,
        "node_log_probs": outs.log_probs,
        "node_probs": outs.probs,
        "node_preds": outs.preds,
        "node_entropy": outs.entropy,
        "preds": preds,
        "logits": F.one_hot(preds, jt.num_classes).float(),
    }


# ---------------------------------------------------------------------------
# Stateful wrappers with the reference's class API
# ---------------------------------------------------------------------------


class EmbeddedDecisionRules:
    """Construct from a Tree (or dataset paths), call on backbone logits."""

    def __init__(
        self,
        dataset: Optional[str] = None,
        path_graph: Optional[str] = None,
        path_wnids: Optional[str] = None,
        classes=(),
        hierarchy: Optional[str] = None,
        tree: Optional[Tree] = None,
        device="cuda",
    ):
        if tree is None:
            tree = Tree(
                dataset, path_graph, path_wnids, list(classes) or None,
                hierarchy=hierarchy,
            )
        self.tree = tree
        self.device = resolve_device(device)
        self.jt = to_device_tree(tree.arrays, self.device)

    def _input(self, outputs) -> torch.Tensor:
        return torch.as_tensor(outputs, device=self.device)

    def forward_nodes(self, outputs) -> Dict[str, dict]:
        """Per-inode output dicts keyed by wnid, as numpy arrays trimmed to
        each node's true child count."""
        outs = get_all_node_outputs(self._input(outputs), self.jt)
        logits, probs, preds, ent = (
            t.cpu().numpy() for t in (outs.logits, outs.probs, outs.preds, outs.entropy)
        )
        result = {}
        for i, node in enumerate(self.tree.inodes):
            k = node.num_classes
            result[node.wnid] = {
                "logits": logits[:, i, :k],
                "preds": preds[:, i],
                "probs": probs[:, i, :k],
                "entropy": ent[:, i],
            }
        return result

    def __call__(self, outputs):
        return self.forward(outputs)


class SoftEmbeddedDecisionRules(EmbeddedDecisionRules):
    def forward(self, outputs):
        """Leaf distribution [B, C], tagged as NBDT output."""
        from .model import TaggedOutput

        return TaggedOutput(soft_forward(self._input(outputs), self.jt))

    def forward_with_decisions(self, outputs):
        """Returns (class_probs, decisions). Each decision is the list of
        steps down the argmax leaf's path with per-sample prob/entropy."""
        from .model import TaggedOutput

        outs = soft_outputs(self._input(outputs), self.jt)
        decisions = self._build_decisions(
            outs["preds"].cpu().numpy(),
            outs["node_probs"].cpu().numpy(),
            outs["node_entropy"].cpu().numpy(),
        )
        return TaggedOutput(outs["class_probs"]), decisions

    def _build_decisions(self, preds, node_probs, node_ent):
        wnid_to_inode = {w: i for i, w in enumerate(self.tree.arrays.wnids_inodes)}
        leaf_to_steps = self.tree.get_leaf_to_steps()
        decisions = []
        for b, pred in enumerate(preds):
            steps = [dict(s) for s in leaf_to_steps[self.tree.wnids_leaves[int(pred)]]]
            probs = [1.0]
            entropies = [0.0]
            for step in steps[:-1]:
                i = wnid_to_inode[step["node"].wnid]
                probs.append(float(node_probs[b, i, step["next_index"]]))
                entropies.append(float(node_ent[b, i]))
            for step, prob, entropy in zip(steps, probs, entropies):
                step["prob"] = prob
                step["entropy"] = entropy
            decisions.append(steps)
        return decisions


class HardEmbeddedDecisionRules(EmbeddedDecisionRules):
    def forward(self, outputs):
        """One-hot logits [B, C] of the greedy root->leaf walk, tagged."""
        from .model import TaggedOutput

        return TaggedOutput(hard_forward(self._input(outputs), self.jt))

    def forward_with_decisions(self, outputs):
        from .model import TaggedOutput

        outs = hard_outputs(self._input(outputs), self.jt)
        preds = outs["preds"].cpu().numpy()
        node_probs = outs["node_probs"].cpu().numpy()
        node_preds = outs["node_preds"].cpu().numpy()
        node_ent = outs["node_entropy"].cpu().numpy()

        wnid_to_inode = {w: i for i, w in enumerate(self.tree.arrays.wnids_inodes)}
        decisions = []
        for b in range(preds.shape[0]):
            node = self.tree.root
            decision = [{"node": node, "name": "root", "prob": 1.0, "entropy": 0.0}]
            while not node.is_leaf():
                i = wnid_to_inode[node.wnid]
                index_child = int(node_preds[b, i])
                prob_child = float(node_probs[b, i, index_child])
                entropy = float(node_ent[b, i])
                node = node.children[index_child]
                decision.append(
                    {
                        "node": node,
                        "name": node.name,
                        "prob": prob_child,
                        "next_index": index_child,
                        "entropy": entropy,
                    }
                )
            decisions.append(decision)
        return TaggedOutput(outs["logits"]), decisions
