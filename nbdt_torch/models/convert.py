"""Flax variables -> the port's torch state dict (ResNet, WRN and ViT layouts).

The JAX package's variables arrive as nested dicts of numpy arrays
(``params`` plus ``batch_stats``). The transposes are those of the JAX
package's converter: conv kernels HWIO -> OIHW, Dense kernels ``[D, C]`` ->
``weight [C, D]``, and for the ViT the per-head q/k/v kernels ``[D, H, hd]``
packed into torchvision's ``in_proj_weight [3D, D]`` and the output kernel
``[H, hd, D]`` into ``out_proj.weight [D, D]``. The keys are the reference
torch names (torchvision's for the ViT), the same set that
``nbdt_tpu.models.convert.flax_to_torch_state_dict`` emits, but for the
WRN: there the keys are pytorchcv's (``features.init_block.weight``,
``...identity_conv.weight``), while the JAX package's exporter writes
``features.init_block.conv.weight`` and ``...identity_conv.conv.weight``.
:func:`pytorchcv_wrn_keys` turns either grammar into pytorchcv's.
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


def _vit_state_dict(params) -> Dict[str, np.ndarray]:
    """torchvision ViT keys from a JAX ViT's params, of any depth (the
    ``block{i}`` entries) and head count (the q kernel's middle axis)."""
    out = {
        "conv_proj.weight": np.transpose(np.asarray(params["patch_embed"]["kernel"]), (3, 2, 0, 1)),
        "conv_proj.bias": np.asarray(params["patch_embed"]["bias"]),
        "class_token": np.asarray(params["cls"]),
        "encoder.pos_embedding": np.asarray(params["pos_embed"]),
    }
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        blk, key = params[f"block{i}"], f"encoder.layers.encoder_layer_{i}"
        attn = blk["attn"]
        qkv = [attn[n] for n in ("query", "key", "value")]
        d = np.asarray(qkv[0]["kernel"]).shape[0]
        out[f"{key}.self_attention.in_proj_weight"] = np.concatenate(
            [np.asarray(p["kernel"]).reshape(d, d).T for p in qkv])
        out[f"{key}.self_attention.in_proj_bias"] = np.concatenate(
            [np.asarray(p["bias"]).reshape(-1) for p in qkv])
        out[f"{key}.self_attention.out_proj.weight"] = np.asarray(
            attn["out"]["kernel"]).reshape(d, d).T
        out[f"{key}.self_attention.out_proj.bias"] = np.asarray(attn["out"]["bias"])
        for flax_name, torch_name in (("ln1", "ln_1"), ("ln2", "ln_2"), ("fc1", "mlp.0"),
                                      ("fc2", "mlp.3")):
            _affine(out, f"{key}.{torch_name}", blk[flax_name])
    _affine(out, "encoder.ln", params["ln"])
    _affine(out, "heads.head", params["output"])
    return out


def _affine(out, key: str, leaf) -> None:
    """A LayerNorm (scale, bias) or Dense (kernel [I, O] -> weight [O, I])."""
    if "scale" in leaf:
        out[f"{key}.weight"] = np.asarray(leaf["scale"])
    else:
        out[f"{key}.weight"] = np.asarray(leaf["kernel"]).T
    out[f"{key}.bias"] = np.asarray(leaf["bias"])


def _wrn_state_dict(params, stats) -> Dict[str, np.ndarray]:
    """pytorchcv WRN keys from a JAX WRN's variables, of any depth and width
    (the ``stageS_unitU`` entries)."""
    out: Dict[str, np.ndarray] = {}

    def conv(key, leaf):
        out[f"{key}.weight"] = np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1))

    def bn(key, leaf, stat):
        for flax_part, coll, torch_part in _BN_PARTS:
            out[f"{key}.{torch_part}"] = np.asarray((leaf if coll == "params" else stat)[flax_part])

    conv("features.init_block", params["init_conv"])
    for name, unit in params.items():
        m = re.fullmatch(r"stage(\d+)_unit(\d+)", name)
        if not m:
            continue
        base = f"features.stage{m.group(1)}.unit{m.group(2)}"
        for i in (1, 2):
            bn(f"{base}.body.conv{i}.bn", unit[f"bn{i}"], stats[name][f"bn{i}"])
            conv(f"{base}.body.conv{i}.conv", unit[f"conv{i}"])
        if "identity_conv" in unit:
            conv(f"{base}.identity_conv", unit["identity_conv"])
    bn("features.post_activ.bn", params["post_bn"], stats["post_bn"])
    _affine(out, "output", params["output"])
    return out


def pytorchcv_wrn_keys(state_dict: dict) -> dict:
    """A WRN state dict in pytorchcv's key grammar, from either grammar:
    the JAX package's exporter writes ``features.init_block.conv.weight``
    and ``...identity_conv.conv.weight`` where pytorchcv (and a released
    reference checkpoint) has ``features.init_block.weight`` and
    ``...identity_conv.weight``. Other keys pass unchanged."""
    return {re.sub(r"^(features\.init_block|.*\.identity_conv)\.conv\.weight$",
                   r"\1.weight", k): v for k, v in state_dict.items()}


def state_dict_from_flax(variables, arch: str) -> Dict[str, torch.Tensor]:
    """Convert ``{"params": ..., "batch_stats": ...}`` of a JAX ResNet, WRN
    or ViT into a state dict that the port's module of the same ``arch``
    loads strictly. ``arch`` is ``ResNet*``, ``wrn28_10*`` or ``WRN`` (a WRN
    of any depth and width), ``vit_b16``, ``vit_s16`` or ``ViT`` (a ViT of
    any depth and width)."""
    if arch in ("vit_b16", "vit_s16", "ViT"):
        out = _vit_state_dict(variables["params"])
        return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}
    if arch == "WRN" or arch.startswith("wrn28_10"):
        out = _wrn_state_dict(variables["params"], variables.get("batch_stats", {}))
        return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}
    if not arch.startswith("ResNet"):
        raise NotImplementedError(
            f"state_dict_from_flax handles the CIFAR ResNets, the WRNs and the ViTs, "
            f"not {arch!r}")
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
