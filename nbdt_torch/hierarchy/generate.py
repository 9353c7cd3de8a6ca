"""Classifier probe (counterpart of ``get_classifier_from_flax_params`` in
``nbdt_tpu/hierarchy/generate.py``)."""

from __future__ import annotations

import numpy as np
import torch.nn as nn


def get_classifier_from_module(module: nn.Module):
    """The classifier of a backbone as ``(kernel [D, C], bias [C] or None)``,
    numpy f32, read from its ``linear`` layer (``linear.weight`` is ``[C, D]``,
    so it is transposed to the JAX package's kernel layout)."""
    linear = getattr(module, "linear", None)
    if not isinstance(linear, nn.Linear):
        return None, None
    kernel = linear.weight.detach().float().cpu().numpy().T
    bias = None if linear.bias is None else linear.bias.detach().float().cpu().numpy()
    return np.ascontiguousarray(kernel), bias
