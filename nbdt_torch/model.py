"""NBDT model wrappers: backbone -> decision rules.

Counterpart of ``nbdt_tpu/model.py``. A wrapper composes a backbone
``nn.Module`` (NCHW inside) with embedded decision rules. Public inputs keep
the JAX package's layout, NHWC ``[B, H, W, 3]``; the wrapper permutes once at
the entry, which hands the backbone a channels-last tensor.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.nn as nn

from .hierarchy.generate import CLASSIFIER_NAMES, get_classifier_from_module
from .models.convert import pytorchcv_wrn_keys
from .models.fold import fold_batchnorm
from .ops.soft_traversal import fused_soft_head, prepare_head_constants
from .rules import HardEmbeddedDecisionRules, SoftEmbeddedDecisionRules
from .tree import Tree, dataset_to_dummy_classes
from .utils import DATASET_TO_CLASSES, DATASET_TO_NUM_CLASSES, resolve_device


class TaggedOutput(torch.Tensor):
    """Tensor tagged as NBDT output, so that feeding it back into a tree
    loss can be refused (the reference sets ``_nbdt_output_flag``). Tensors
    derived from it keep the tag."""

    _nbdt_output_flag = True

    def __new__(cls, data):
        return torch.as_tensor(data).as_subclass(cls)


# Train-only auxiliary heads of torchvision's GoogLeNet (aux1, aux2) and
# Inception v3 (AuxLogits): never part of the eval logits, not built in either
# package.
AUX_PREFIXES = ("aux1.", "aux2.", "AuxLogits.")


def load_checkpoint(path) -> dict:
    """A reference-keyed state dict from a local torch ``.pth`` file
    (``net``/``state_dict`` wrapping and ``module.`` prefixes removed; a
    WRN's keys in pytorchcv's grammar, whichever of the two it was saved
    in; a GoogLeNet's or Inception v3's auxiliary heads dropped, with a
    warning that torchvision's pretrained loaders build those models with
    ``transform_input=True``)."""
    path = str(path)
    if not path.endswith((".pth", ".pt")):
        raise ValueError(
            f"nbdt_torch loads pretrained weights from a local torch .pth "
            f"checkpoint only, not {path!r}"
        )
    data = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("net", "state_dict"):
        if isinstance(data, dict) and isinstance(data.get(key), dict):
            data = data[key]
    data = {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in data.items()}
    if any(k.startswith("features.init_block.") for k in data):
        data = pytorchcv_wrn_keys(data)
    if any(k.startswith(("inception3a.", "Mixed_5b.")) for k in data):
        warnings.warn(
            f"{path}: torchvision's pretrained googlenet and inception_v3 checkpoints are "
            "trained with transform_input=True; build the model with transform_input=True "
            "(get_model(arch, n, transform_input=True)) or its logits will differ.",
            stacklevel=2)
        data = {k: v for k, v in data.items() if not k.startswith(AUX_PREFIXES)}
    return data


class NBDT:
    """Backbone + decision rules. ``model`` is an ``nn.Module`` mapping NCHW
    images to logits, with ``features_only=True`` for the pooled features
    when ``fused=True``. Everything runs on ``device`` (CUDA by default)."""

    Rules = HardEmbeddedDecisionRules

    def __init__(
        self,
        dataset: Optional[str],
        model: nn.Module,
        arch: Optional[str] = None,
        path_graph: Optional[str] = None,
        path_wnids: Optional[str] = None,
        classes=None,
        hierarchy: Optional[str] = None,
        pretrained: bool = False,
        tree: Optional[Tree] = None,
        checkpoint_path: Optional[str] = None,
        Rules=None,
        fused: bool = False,
        fold_bn: bool = False,
        device="cuda",
    ):
        if dataset and not hierarchy and not path_graph and tree is None:
            assert arch, "Must specify `arch` if no `hierarchy` or `path_graph`"
            hierarchy = f"induced-{arch}"
        if pretrained and not arch:
            raise UserWarning(
                "To load a pretrained NBDT, specify the `arch` (e.g. ResNet18)."
            )
        if pretrained:
            if not checkpoint_path:
                raise ValueError(
                    "nbdt_torch cannot download checkpoints; pass "
                    "checkpoint_path= to a local .pth file"
                )
            model.load_state_dict(load_checkpoint(checkpoint_path), strict=True)

        self.device = resolve_device(device)
        if classes is None and dataset and tree is None:
            classes = DATASET_TO_CLASSES.get(dataset)
            if classes is None and dataset in DATASET_TO_NUM_CLASSES:
                classes = dataset_to_dummy_classes(dataset)
        if tree is None:
            tree = Tree(dataset, path_graph, path_wnids, classes, hierarchy=hierarchy)
        self.tree = tree
        self.dataset = dataset
        self.arch = arch
        self.hierarchy = hierarchy
        self.rules = (Rules or self.Rules)(tree=tree, device=self.device)

        assert not (fused and fold_bn), (
            "fused=True and fold_bn=True are separate serving paths; the "
            "fused kernel consumes pre-pool features from the unfolded "
            "module — pick one"
        )
        if fold_bn:
            model = fold_batchnorm(model)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self._head = self._build_fused(model, tree) if fused else None

    def _build_fused(self, model, tree):
        assert isinstance(self, SoftNBDT), (
            "fused=True is the soft-rules serving path (hard rules keep the "
            "plain formulation)"
        )
        kernel, bias = get_classifier_from_module(model)
        assert kernel is not None, (
            f"no classifier (an nn.Linear or 1x1 nn.Conv2d named one of {CLASSIFIER_NAMES}) "
            "on the model")
        return prepare_head_constants(tree.arrays, kernel, bias, device=self.device)

    def _input(self, x) -> torch.Tensor:
        """NHWC images -> an NCHW view with channels-last memory."""
        return torch.as_tensor(x, device=self.device).permute(0, 3, 1, 2)

    @torch.no_grad()
    def forward(self, x):
        if self._head is not None:
            feats = self.model(self._input(x), features_only=True)
            (leaf_logp,) = fused_soft_head(feats, self._head, want_aux=False)
            # exp(leaf log-probs) == the rules' raw probability product
            return TaggedOutput(torch.exp(leaf_logp))
        return self.rules(self.model(self._input(x)))

    __call__ = forward

    @torch.no_grad()
    def forward_with_decisions(self, x):
        return self.rules.forward_with_decisions(self.model(self._input(x)))


class HardNBDT(NBDT):
    Rules = HardEmbeddedDecisionRules


class SoftNBDT(NBDT):
    Rules = SoftEmbeddedDecisionRules
