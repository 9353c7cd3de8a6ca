"""NBDT model wrappers: backbone -> decision rules.

Counterpart of ``nbdt_tpu/model.py``. A wrapper composes a backbone
``nn.Module`` (NCHW inside) with embedded decision rules. Public inputs keep
the JAX package's layout, NHWC ``[B, H, W, 3]``; the wrapper permutes once at
the entry, which hands the backbone a channels-last tensor.

``pretrained=True`` loads the released checkpoint of ``(arch, dataset[,
hierarchy])`` from ``model_urls`` through the local cache
(:mod:`nbdt_torch.models.utils`), or ``checkpoint_path``: a torch ``.pth``
or the JAX package's ``.msgpack``.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.nn as nn

from .hierarchy.generate import CLASSIFIER_NAMES, get_classifier_from_module
from .models.convert import pytorchcv_wrn_keys, state_dict_from_flax
from .models.fold import fold_batchnorm
from .models.utils import cached_checkpoint, load_torch_checkpoint
from .ops.soft_traversal import fused_soft_head, prepare_head_constants
from .rules import HardEmbeddedDecisionRules, SoftEmbeddedDecisionRules
from .serialization import read_msgpack
from .tree import Tree, dataset_to_dummy_classes
from .utils import DATASET_TO_CLASSES, DATASET_TO_NUM_CLASSES, resolve_device

# Released NBDT checkpoints (the JAX package's table, ``nbdt_tpu/model.py``),
# fetched into the local cache only when a file is not there yet.
_RELEASES = "https://github.com/alvinwan/neural-backed-decision-trees/releases/download/0.0.1"
model_urls = {
    ("ResNet18", "CIFAR10"): f"{_RELEASES}/ckpt-CIFAR10-ResNet18-induced-ResNet18-SoftTreeSupLoss.pth",
    ("wrn28_10_cifar10", "CIFAR10"): f"{_RELEASES}/ckpt-CIFAR10-wrn28_10_cifar10-induced-wrn28_10_cifar10-SoftTreeSupLoss.pth",
    ("wrn28_10_cifar10", "CIFAR10", "wordnet"): f"{_RELEASES}/ckpt-CIFAR10-wrn28_10_cifar10-wordnet-SoftTreeSupLoss.pth",
    ("ResNet18", "CIFAR100"): f"{_RELEASES}/ckpt-CIFAR100-ResNet18-induced-ResNet18-SoftTreeSupLoss.pth",
    ("wrn28_10_cifar100", "CIFAR100"): f"{_RELEASES}/ckpt-CIFAR100-wrn28_10_cifar100-induced-wrn28_10_cifar100-SoftTreeSupLoss.pth",
    ("ResNet18", "TinyImagenet200"): f"{_RELEASES}/ckpt-TinyImagenet200-ResNet18-induced-ResNet18-SoftTreeSupLoss-tsw10.0.pth",
    ("wrn28_10", "TinyImagenet200"): f"{_RELEASES}/ckpt-TinyImagenet200-wrn28_10-induced-wrn28_10-SoftTreeSupLoss-tsw10.0.pth",
}


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


def load_checkpoint(path, arch: Optional[str] = None) -> dict:
    """A reference-keyed state dict from a local checkpoint: a torch
    ``.pth``/``.pt`` (``net``/``state_dict`` wrapping and ``module.``
    prefixes removed; a WRN's keys in pytorchcv's grammar, whichever of the
    two it was saved in; a GoogLeNet's or Inception v3's auxiliary heads
    dropped, with a warning that torchvision's pretrained loaders build
    those models with ``transform_input=True``), or the JAX package's
    ``.msgpack`` (``{"params", "batch_stats"}``), converted for ``arch``
    by :func:`~nbdt_torch.models.convert.state_dict_from_flax`."""
    path = str(path)
    if path.endswith(".msgpack"):
        if arch is None:
            raise ValueError(f"{path}: a .msgpack checkpoint holds flax variables; pass arch= "
                             "to map them onto the port's module")
        return state_dict_from_flax(read_msgpack(path), arch)
    if not path.endswith((".pth", ".pt")):
        raise ValueError(
            f"nbdt_torch loads a local torch .pth or the JAX package's .msgpack, not {path!r}"
        )
    data = load_torch_checkpoint(path)
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


def pretrained_checkpoint(arch: str, dataset: Optional[str], hierarchy: Optional[str] = None,
                          checkpoint_path: Optional[str] = None, urls: Optional[dict] = None):
    """``checkpoint_path`` if given, else the cached file of the released
    checkpoint keyed ``(arch, dataset)`` or ``(arch, dataset, hierarchy)``
    in ``urls`` (:data:`model_urls` by default; the last key found wins)."""
    if checkpoint_path:
        return checkpoint_path
    keys = [(arch, dataset), (arch, dataset, hierarchy)]
    return cached_checkpoint(keys, model_urls if urls is None else urls)


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
            path = pretrained_checkpoint(arch, dataset, hierarchy, checkpoint_path)
            model.load_state_dict(load_checkpoint(path, arch=arch), strict=True)

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
