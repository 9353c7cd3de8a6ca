"""Flax variables -> the port's torch state dict (ResNet layout).

The JAX package's variables arrive as nested dicts of numpy arrays
(``params`` plus ``batch_stats``). The transposes are those of the JAX
package's converter: conv kernels HWIO -> OIHW, and the Dense kernel
``[D, C]`` -> ``linear.weight [C, D]``. The keys are the reference torch
names, the same set that ``nbdt_tpu.models.convert.flax_to_torch_state_dict``
emits for a ResNet.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_BN_PARTS = (("scale", "params", "weight"), ("bias", "params", "bias"),
             ("mean", "batch_stats", "running_mean"),
             ("var", "batch_stats", "running_var"))


def _torch_name(flax_name: str) -> str:
    """``layer2_1`` -> ``layer2.1``, ``shortcut_conv`` -> ``shortcut.0``,
    ``shortcut_bn`` -> ``shortcut.1``; other names are unchanged."""
    m = re.fullmatch(r"layer(\d+)_(\d+)", flax_name)
    if m:
        return f"layer{m.group(1)}.{m.group(2)}"
    return {"shortcut_conv": "shortcut.0", "shortcut_bn": "shortcut.1"}.get(
        flax_name, flax_name)


def state_dict_from_flax(variables, arch: str) -> Dict[str, torch.Tensor]:
    """Convert ``{"params": ..., "batch_stats": ...}`` of a JAX ResNet into a
    state dict that the port's ResNet of the same ``arch`` loads strictly."""
    if not arch.startswith("ResNet"):
        raise NotImplementedError(f"state_dict_from_flax handles the CIFAR ResNets, not {arch!r}")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}

    def walk(p, s, prefix):
        for name, leaf in p.items():
            key = prefix + _torch_name(name)
            if name == "linear":
                out[f"{key}.weight"] = np.asarray(leaf["kernel"]).T
                out[f"{key}.bias"] = np.asarray(leaf["bias"])
            elif "kernel" in leaf:  # conv
                out[f"{key}.weight"] = np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1))
                if "bias" in leaf:
                    out[f"{key}.bias"] = np.asarray(leaf["bias"])
            elif "scale" in leaf:  # BatchNorm
                for flax_part, coll, torch_part in _BN_PARTS:
                    src = leaf if coll == "params" else s[name]
                    out[f"{key}.{torch_part}"] = np.asarray(src[flax_part])
            else:  # a block
                walk(leaf, s.get(name, {}), key + ".")

    walk(params, stats, "")
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}
