"""Inference-time BatchNorm folding for the ResNet family (the CIFAR
ResNets, torchvision's ImageNet ResNets, ResNeXts and wide ResNets).

Counterpart of ``nbdt_tpu/models/fold.py``. At inference a BatchNorm is the
per-channel affine ``y = x*s + t`` with ``s = gamma/sqrt(var+eps)`` and
``t = beta - mean*s``. Folding multiplies ``s`` into the preceding conv's
weight and turns ``t`` into a conv bias, so the serving graph is pure
conv+bias+ReLU. The math runs on the host in float64, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .resnet import ResNet


def _bn_key_for(conv_key: str) -> str:
    """State-dict prefix of the BatchNorm that follows a conv."""
    if conv_key.endswith(("shortcut.0", "downsample.0")):
        return conv_key[: -len("0")] + "1"
    head, _, name = conv_key.rpartition(".")
    assert name.startswith("conv"), conv_key
    return (head + "." if head else "") + "bn" + name[len("conv"):]


def _fold_state_dict(module: ResNet) -> Dict[str, torch.Tensor]:
    sd = {k: v.detach().cpu().double().numpy() for k, v in module.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for name, m in module.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            bn = _bn_key_for(name)
            eps = module.get_submodule(bn).eps
            s = sd[f"{bn}.weight"] / np.sqrt(sd[f"{bn}.running_var"] + eps)
            out[f"{name}.weight"] = sd[f"{name}.weight"] * s[:, None, None, None]
            out[f"{name}.bias"] = sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * s
    for part in ("weight", "bias"):
        out[f"{module.head_name}.{part}"] = sd[f"{module.head_name}.{part}"]
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in out.items()}


def fold_batchnorm(module: ResNet) -> ResNet:
    """Return a folded module computing the same inference function as
    ``module.eval()``, on the same device and in the same ``dtype``."""
    if not isinstance(module, ResNet) or module.folded:
        raise TypeError(
            f"{type(module).__name__} has no folded-inference variant; "
            "BN folding supports the unfolded ResNet family"
        )
    folded = module.clone(folded=True)
    folded.load_state_dict(_fold_state_dict(module))
    device = module.conv1.weight.device
    return folded.to(device).eval()
