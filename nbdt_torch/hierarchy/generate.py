"""Classifier probe (counterpart of ``get_classifier_from_flax_params`` in
``nbdt_tpu/hierarchy/generate.py``)."""

from __future__ import annotations

import numpy as np
import torch.nn as nn

# The JAX package's probe order, then torchvision's ViT classifier.
CLASSIFIER_NAMES = ("linear", "fc", "classifier", "head", "output", "heads.head")


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
