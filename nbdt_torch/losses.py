"""Tree-supervision losses in plain PyTorch.

Counterpart of ``nbdt_tpu/losses.py``: functions on tensors first (used
inside the train step, differentiable), the stateful wrappers with the
reference's class API second (construct with a Tree, ``set_epoch`` for the
weight schedules, call on (outputs, targets)).

Two reference quirks are kept as the JAX package keeps them:

* ``SoftTreeSupLoss.forward_tree`` is ``criterion(rules(outputs), targets)``:
  the raw product-of-probabilities leaf distribution is treated as logits
  and soft-maxed again, i.e. softmax CE over ``exp(leaf_log_probs)``.
* ``HardTreeSupLoss`` scales its tree term by ``tree_supervision_weight``
  inside ``forward_tree`` and again through the scheduled tree weight, so
  the hard term carries tsw squared when no schedule is set.

The hard loss is the reference's per-child-count buckets of per-node CE in
one masked gather: a mean times its count is a sum, so the total is
``tsw * sum over valid (sample, node) pairs of CE / (B * N / 2)``.

The losses take the plain rules (``nbdt_torch.rules``); their two tree
matmuls stay exact f32 in the backward too (``rules.exact_matmul``). The
fused head kernel has no backward, in either package.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from .rules import (
    DeviceTreeArrays,
    get_all_node_outputs,
    get_node_logits,
    masked_log_softmax,
    soft_leaf_log_probs,
    to_device_tree,
)
from .tree import Tree
from .utils import resolve_device

# The CLI's --loss choices, the reference registry's names.
names = (
    "HardTreeSupLoss",
    "SoftTreeSupLoss",
    "SoftTreeLoss",
    "CrossEntropyLoss",
)


# ---------------------------------------------------------------------------
# Functions on tensors
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, targets[:, None].long()).mean()


def soft_rules_distribution(logits: torch.Tensor, jt: DeviceTreeArrays) -> torch.Tensor:
    """The soft rules' leaf distribution (the product of per-node child
    probabilities), as the reference feeds it to the wrapped criterion."""
    outs = get_all_node_outputs(logits, jt)
    return torch.exp(soft_leaf_log_probs(outs.log_probs, jt))


def soft_tree_sup_loss(logits: torch.Tensor, targets: torch.Tensor, jt: DeviceTreeArrays,
                       criterion: Optional[Callable] = None) -> torch.Tensor:
    """The base criterion (cross-entropy by default) on the soft rules' leaf
    distribution used as logits."""
    return (criterion or cross_entropy)(soft_rules_distribution(logits, jt), targets)


def hard_tree_sup_loss(logits: torch.Tensor, targets: torch.Tensor, jt: DeviceTreeArrays,
                       tree_supervision_weight: float = 1.0) -> torch.Tensor:
    """Masked child-level CE over every (sample, node) pair whose class lies
    under the node (see the module docstring)."""
    B = logits.shape[0]
    N, K, _ = jt.membership.shape
    log_probs, _ = masked_log_softmax(get_node_logits(logits, jt), jt.child_mask)
    tc = jt.target_child[:, targets.long()].T  # [B, N], -1 where the class is not under n
    valid = tc >= 0
    pair_nll = -log_probs.gather(2, tc.clamp(0, K - 1)[..., None])[..., 0]
    pair_nll = torch.where(valid, pair_nll, 0.0)
    return pair_nll.sum() / (B * N / 2.0) * tree_supervision_weight


def hard_tree_sup_loss_custom(logits: torch.Tensor, targets: torch.Tensor,
                              jt: DeviceTreeArrays, criterion: Callable,
                              tree_supervision_weight: float = 1.0) -> torch.Tensor:
    """The hard loss with any criterion that is a mean of per-sample terms:
    per distinct child count k, each node's k true child-logit columns, the
    criterion mapped over single (sample, node) pairs by ``torch.func.vmap``,
    summed over the valid pairs."""
    B = logits.shape[0]
    N, K, _ = jt.membership.shape
    nl = get_node_logits(logits, jt)
    tc = jt.target_child[:, targets.long()].T
    valid = tc >= 0
    counts = jt.child_mask.sum(1).cpu()
    per_pair = torch.func.vmap(lambda row, t: criterion(row[None], t[None]))
    total = nl.new_zeros(())
    for k in sorted(set(counts.tolist())):
        idx = torch.nonzero(counts == k)[:, 0].to(nl.device)
        rows = nl[:, idx, :k].reshape(-1, k)
        t = tc[:, idx].reshape(-1)
        v = valid[:, idx].reshape(-1)
        vals = per_pair(rows, torch.where(v, t, 0))
        total = total + torch.where(v, vals, 0.0).sum()
    return total / (B * N / 2.0) * tree_supervision_weight


def scheduled_weight(start: float, end: float, progress: float, power: float = 1.0):
    """Linearly (or power-curved) interpolated weight."""
    p = progress ** power
    return (1 - p) * start + p * end


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         ignore_label: int = -1) -> torch.Tensor:
    """Mean CE over the rows whose label is not ``ignore_label``."""
    valid = targets != ignore_label
    safe = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = torch.where(valid, -logp.gather(1, safe[:, None])[:, 0], 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


def soft_seg_tree_sup_loss(logits: torch.Tensor, targets: torch.Tensor, jt: DeviceTreeArrays,
                           ignore_label: int = -1) -> torch.Tensor:
    """Per-pixel soft tree loss: CE of the valid pixels against the soft
    rules' leaf distribution."""
    return masked_cross_entropy(soft_rules_distribution(logits, jt), targets, ignore_label)


# ---------------------------------------------------------------------------
# Stateful wrappers (the reference's class API)
# ---------------------------------------------------------------------------


def assert_output_not_nbdt(outputs) -> None:
    """Refuse an NBDT model's output (a ``TaggedOutput``) as a loss input.

    >>> import torch
    >>> assert_output_not_nbdt(torch.zeros(1, 10))  # all good
    >>> from nbdt_torch.model import TaggedOutput
    >>> assert_output_not_nbdt(TaggedOutput(torch.zeros(1, 10)))  #doctest: +ELLIPSIS
    Traceback (most recent call last):
        ...
    AssertionError: ...
    """
    assert getattr(outputs, "_nbdt_output_flag", False) is False, (
        "Uh oh! Looks like you passed an NBDT model's output to an NBDT "
        "loss. NBDT losses are designed to take in the *original* model's "
        "outputs, as input. NBDT models are designed to only be used "
        "during validation and inference, not during training."
    )


class TreeSupLoss:
    """Scheduled combination of a base criterion and a tree term. The tree
    constants live on ``device`` (CUDA by default)."""

    def __init__(
        self,
        dataset: Optional[str] = None,
        criterion: Optional[Callable] = None,
        path_graph: Optional[str] = None,
        path_wnids: Optional[str] = None,
        classes=None,
        hierarchy: Optional[str] = None,
        tree: Optional[Tree] = None,
        tree_supervision_weight: float = 1.0,
        tree_supervision_weight_end: Optional[float] = None,
        tree_supervision_weight_power: float = 1.0,
        xent_weight: float = 1.0,
        xent_weight_end: Optional[float] = None,
        xent_weight_power: float = 1.0,
        device="cuda",
    ):
        if tree is None:
            tree = Tree(dataset, path_graph, path_wnids, classes, hierarchy=hierarchy)
        self.tree = tree
        self.device = resolve_device(device)
        self.jt = to_device_tree(tree.arrays, self.device)
        self.num_classes = len(tree.classes)
        self.criterion = criterion or cross_entropy
        self.tree_supervision_weight = tree_supervision_weight
        self.tree_supervision_weight_end = (
            tree_supervision_weight_end if tree_supervision_weight_end is not None
            else tree_supervision_weight)
        self.tree_supervision_weight_power = tree_supervision_weight_power
        self.xent_weight = xent_weight
        self.xent_weight_end = xent_weight_end if xent_weight_end is not None else xent_weight
        self.xent_weight_power = xent_weight_power
        self.progress = 1.0
        self.epochs = 0

    def _tensor(self, x) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=self.device)

    def forward_tree(self, outputs, targets):
        raise NotImplementedError()

    def get_weight(self, start, end, power=1.0):
        return scheduled_weight(start, end, self.progress, power)

    def forward(self, outputs, targets):
        assert_output_not_nbdt(outputs)
        outputs, targets = self._tensor(outputs), self._tensor(targets)
        loss_xent = self.criterion(outputs, targets)
        loss_tree = self.forward_tree(outputs, targets)
        tree_weight = self.get_weight(self.tree_supervision_weight,
                                      self.tree_supervision_weight_end,
                                      self.tree_supervision_weight_power)
        xent_weight = self.get_weight(self.xent_weight, self.xent_weight_end,
                                      self.xent_weight_power)
        return loss_xent * xent_weight + loss_tree * tree_weight

    def __call__(self, outputs, targets):
        return self.forward(outputs, targets)

    def set_epoch(self, cur: int, total: int) -> None:
        self.epochs = cur
        self.progress = cur / total


class HardTreeSupLoss(TreeSupLoss):
    def forward_tree(self, outputs, targets):
        assert_output_not_nbdt(outputs)
        outputs, targets = self._tensor(outputs), self._tensor(targets)
        if self.criterion is cross_entropy:  # CE: one masked gather over all pairs
            return hard_tree_sup_loss(outputs, targets, self.jt,
                                      tree_supervision_weight=self.tree_supervision_weight)
        return hard_tree_sup_loss_custom(outputs, targets, self.jt, criterion=self.criterion,
                                         tree_supervision_weight=self.tree_supervision_weight)


class SoftTreeSupLoss(TreeSupLoss):
    def forward_tree(self, outputs, targets):
        assert_output_not_nbdt(outputs)
        return soft_tree_sup_loss(self._tensor(outputs), self._tensor(targets), self.jt,
                                  criterion=self.criterion)


class SoftTreeLoss(SoftTreeSupLoss):
    """Soft tree loss over a self-updating induced hierarchy: the plain
    criterion before ``tree_start_epochs``, then the induced tree is
    regenerated from the live model every ``tree_update_every_epochs``
    until ``tree_update_end_epochs``. ``model_fn`` returns the live
    ``nn.Module`` whose classifier gives the class centers."""

    def __init__(
        self,
        *args,
        arch: Optional[str] = None,
        checkpoint_path: str = "./",
        model_fn: Optional[Callable] = None,
        tree_start_epochs: int = 67,
        tree_update_every_epochs: int = 10,
        tree_update_end_epochs: int = 120,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.start_epochs = tree_start_epochs
        self.update_every_epochs = tree_update_every_epochs
        self.update_end_epochs = tree_update_end_epochs
        self.model_fn = model_fn
        self.arch = arch
        self.checkpoint_path = checkpoint_path

    def forward_tree(self, outputs, targets):
        if self.epochs < self.start_epochs:
            return self.criterion(self._tensor(outputs), self._tensor(targets))
        return super().forward_tree(outputs, targets)

    def set_epoch(self, cur: int, total: int) -> None:
        super().set_epoch(cur, total)
        offset = self.epochs - self.start_epochs
        if offset >= 0 and offset % self.update_every_epochs == 0 \
                and self.epochs < self.update_end_epochs:
            if self.model_fn is None:
                raise RuntimeError(
                    "SoftTreeLoss is due to regenerate its induced hierarchy at epoch "
                    f"{self.epochs} but was constructed without model_fn; pass "
                    "model_fn=lambda: trainer.model (or use loss='SoftTreeSupLoss' for a "
                    "fixed tree).")
            checkpoint_dir = self.checkpoint_path.replace(".pth", "")
            path_graph = os.path.join(checkpoint_dir, f"graph-epoch{self.epochs}.json")
            self.tree.update_from_model(self.model_fn(), self.arch, self.tree.dataset,
                                        path_graph=path_graph)
            self.jt = to_device_tree(self.tree.arrays, self.device)


class SoftSegTreeSupLoss(SoftTreeSupLoss):
    """Per-pixel soft tree loss for segmentation. Outputs are NHWC class
    maps; targets NHW labels with ``ignore_label`` on void pixels (left out
    of both terms)."""

    def __init__(self, *args, ignore_label: int = -1, **kwargs):
        super().__init__(*args, **kwargs)
        self.ignore_label = ignore_label

    def _seg_criterion(self, outputs, targets):
        """The criterion on NHWC maps and NHW labels: the default CE becomes
        the void-masking flattened form; a custom criterion gets the maps as
        they are."""
        if self.criterion is cross_entropy:
            return masked_cross_entropy(outputs.reshape(-1, outputs.shape[-1]),
                                        targets.reshape(-1), self.ignore_label)
        return self.criterion(outputs, targets)

    def forward(self, outputs, targets):
        assert_output_not_nbdt(outputs)
        outputs, targets = self._tensor(outputs), self._tensor(targets)
        loss = self._seg_criterion(outputs, targets)
        flat = outputs.reshape(-1, outputs.shape[-1])
        bayesian = soft_rules_distribution(flat, self.jt).reshape(outputs.shape)
        return loss + self._seg_criterion(bayesian, targets) * self.tree_supervision_weight


class CrossEntropyLoss:
    """The reference's alias, with the same call and epoch protocol."""

    def __init__(self, *args, device="cuda", **kwargs):
        self.device = resolve_device(device)

    def __call__(self, outputs, targets):
        def t(x):
            return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=self.device)

        return cross_entropy(t(outputs), t(targets))

    def set_epoch(self, cur: int, total: int) -> None:
        pass
