"""Flax variables -> the port's torch state dict (ResNet, WRN, EfficientNet,
ViT, zoo and SegNet layouts).

The JAX package's variables arrive as nested dicts of numpy arrays
(``params`` plus ``batch_stats``). The transposes are those of the JAX
package's converter: conv kernels HWIO -> OIHW, Dense kernels ``[D, C]`` ->
``weight [C, D]``, and for the ViT the per-head q/k/v kernels ``[D, H, hd]``
packed into torchvision's ``in_proj_weight [3D, D]`` and the output kernel
``[H, hd, D]`` into ``out_proj.weight [D, D]``. The keys are the reference
torch names, the same set that
``nbdt_tpu.models.convert.flax_to_torch_state_dict`` emits: the reference's
``shortcut.N``/``linear`` for the CIFAR ResNets (capitalised archs),
torchvision's ``downsample.N``/``fc`` for its ImageNet ResNets (lowercase
archs) and for the ViT, pytorchcv's for the EfficientNets (a depthwise
kernel ``[kh, kw, 1, C]`` becomes ``[C, 1, kh, kw]`` by the same transpose),
but for the WRN: there the keys are pytorchcv's (``features.init_block.weight``,
``...identity_conv.weight``), while the JAX package's exporter writes
``features.init_block.conv.weight`` and ``...identity_conv.conv.weight``.
:func:`pytorchcv_wrn_keys` turns either grammar into pytorchcv's.

The rest of the zoo (MobileNetV2, MNASNet, ShuffleNetV2, DenseNet, AlexNet,
VGG, GoogLeNet, Inception v3, SqueezeNet) carries torchvision's keys, the
set the JAX exporter emits, from one walk over the flax tree with a rename
of each family's module names (a SqueezeNet's conv classifier keeps its
``[C, D, 1, 1]`` weight). The one exception is a VGG with the JAX module's
collapsed head, which has no torchvision form and which the JAX exporter
refuses: its classifier maps to the port's own ``classifier.weight`` and
``classifier.bias``. The seg trainer's SegNet keeps its flax module names
(``c1``, ``bn1``, ..., ``head``) by the same walk.

``python -m nbdt_torch.models.convert ckpt.msgpack --arch A --out ckpt.pth``
converts a JAX checkpoint file, read without flax
(:mod:`nbdt_torch.serialization`).
"""

from __future__ import annotations

import math
import re
import warnings
from collections.abc import Mapping
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .efficientnet import BASE_STAGES, pytorchcv_units
from .efficientnet import COMPOUND as EFFICIENTNET_COMPOUND
from .vgg import CONFIGS as VGG_CONFIGS

_BN_PARTS = (("scale", "params", "weight"), ("bias", "params", "bias"),
             ("mean", "batch_stats", "running_mean"),
             ("var", "batch_stats", "running_var"))


def _torch_name(flax_name: str, torchvision: bool) -> str:
    """``layer2_1`` -> ``layer2.1``, ``shortcut_conv`` -> ``shortcut.0``,
    ``shortcut_bn`` -> ``shortcut.1`` (torchvision: ``downsample.0/.1``, and
    ``linear`` -> ``fc``); other names are unchanged."""
    m = re.fullmatch(r"layer(\d+)_(\d+)", flax_name)
    if m:
        return f"layer{m.group(1)}.{m.group(2)}"
    short, head = ("downsample", "fc") if torchvision else ("shortcut", "linear")
    return {"shortcut_conv": f"{short}.0", "shortcut_bn": f"{short}.1",
            "linear": head}.get(flax_name, flax_name)


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


def _conv_bn(out, key: str, conv, bn, stat) -> None:
    """A conv kernel (HWIO -> OIHW) and the BatchNorm after it, under
    ``{key}.conv`` and ``{key}.bn``."""
    out[f"{key}.conv.weight"] = np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1))
    for flax_part, coll, torch_part in _BN_PARTS:
        out[f"{key}.bn.{torch_part}"] = np.asarray((bn if coll == "params" else stat)[flax_part])


def _efficientnet_state_dict(params, stats) -> Dict[str, np.ndarray]:
    """pytorchcv EfficientNet keys from a JAX EfficientNet's variables, of
    any variant (the ``stage{s}_block{b}`` entries give each base stage's
    depth)."""
    out: Dict[str, np.ndarray] = {}

    def block(key, p, s, conv, bn):
        _conv_bn(out, key, p[conv], p[bn], s[bn])

    block("features.init_block.conv", params, stats, "stem_conv", "stem_bn")
    repeats = [sum(1 for k in params if k.startswith(f"stage{si + 1}_block"))
               for si in range(len(BASE_STAGES))]
    for si, bi, key in pytorchcv_units(repeats):
        name = f"stage{si + 1}_block{bi + 1}"
        p, s = params[name], stats[name]
        if "expand_conv" in p:
            block(f"{key}.conv1", p, s, "expand_conv", "expand_bn")
            dw, pw = f"{key}.conv2", f"{key}.conv3"
        else:
            dw, pw = f"{key}.dw_conv", f"{key}.pw_conv"
        block(dw, p, s, "dw_conv", "dw_bn")
        for torch_name, flax_name in (("conv1", "reduce"), ("conv2", "expand")):
            leaf = p["se"][flax_name]
            out[f"{key}.se.{torch_name}.weight"] = np.transpose(
                np.asarray(leaf["kernel"]), (3, 2, 0, 1))
            out[f"{key}.se.{torch_name}.bias"] = np.asarray(leaf["bias"])
        block(pw, p, s, "project_conv", "project_bn")
    _conv_bn(out, "features.final_block", params["head_conv"], params["head_bn"],
             stats["head_bn"])
    _affine(out, "output.fc", params["output"])
    return out


def state_dict_from_flax(variables, arch: str) -> Dict[str, torch.Tensor]:
    """Convert ``{"params": ..., "batch_stats": ...}`` of a JAX ResNet, WRN,
    EfficientNet or ViT into a state dict that the port's module of the same
    ``arch`` loads strictly. ``arch`` is ``ResNet*`` (the reference's key
    grammar) or ``resnet*``, ``resnext*``, ``wide_resnet*`` (torchvision's),
    as the JAX exporter keys on the arch's case; ``wrn28_10*`` or ``WRN`` (a
    WRN of any depth and width); ``efficientnet_*`` or ``EfficientNet`` (any
    variant); ``vit_b16``, ``vit_s16`` or ``ViT`` (a ViT of any depth and
    width); or a name of the rest of the zoo (``mobilenet_v2``, ``mnasnet*``,
    ``shufflenet_v2_*``, ``densenet*``, ``alexnet``, ``vgg*``, ``googlenet``,
    ``inception_v3``, ``squeezenet*``), or ``SegNet`` (the seg trainer's)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if arch in ("vit_b16", "vit_s16", "ViT"):
        out = _vit_state_dict(params)
    elif arch == "WRN" or arch.startswith("wrn28_10"):
        out = _wrn_state_dict(params, stats)
    elif arch == "EfficientNet" or arch.startswith("efficientnet_"):
        out = _efficientnet_state_dict(params, stats)
    elif arch.startswith(("ResNet", "resnet", "resnext", "wide_resnet")):
        out = _resnet_state_dict(params, stats, torchvision=arch[:1].islower())
    elif _zoo_rename(arch) is not None:
        out = _zoo_state_dict(params, stats, _zoo_rename(arch))
    elif arch == "SegNet":
        out = _zoo_state_dict(params, stats, lambda path, siblings: ".".join(path))
    else:
        raise NotImplementedError(
            f"state_dict_from_flax handles ResNet*, resnet*, resnext*, wide_resnet*, "
            f"wrn28_10*, WRN, efficientnet_*, EfficientNet, vit_b16, vit_s16, ViT, SegNet "
            f"and the zoo's {', '.join(ZOO_PREFIXES)}, not {arch!r}")
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}


def _resnet_state_dict(params, stats, torchvision: bool) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def walk(p, s, prefix):
        for name, leaf in p.items():
            key = prefix + _torch_name(name, torchvision)
            if name == "linear":
                _affine(out, key, leaf)
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
    return out


# The rest of the zoo: flax module path -> torchvision key prefix, given the
# dict that holds the leaf (its siblings).
Rename = Callable[[Tuple[str, ...], Mapping], str]
ZOO_PREFIXES = ("mobilenet_v2", "mnasnet", "shufflenet_v2_", "densenet", "alexnet", "vgg",
                "googlenet", "inception_v3", "squeezenet")


def _mobilenet_name(path, siblings) -> str:
    """``stem``/``stem_bn`` -> ``features.0.{0,1}``, ``head_conv``/``head_bn``
    -> ``features.18.{0,1}``, ``block{i}/{expand,depthwise,project}[_bn]`` ->
    ``features.{i+1}.conv.*`` (the block of expand ratio 1 has no expand
    pair, which shifts the rest), ``classifier`` -> ``classifier.1``."""
    fixed = {"stem": "features.0.0", "stem_bn": "features.0.1", "head_conv": "features.18.0",
             "head_bn": "features.18.1", "classifier": "classifier.1"}
    if len(path) == 1:
        return fixed[path[0]]
    block, sub = path
    order = ["expand", "depthwise", "project"] if "expand" in siblings else ["depthwise",
                                                                              "project"]
    i, bn = order.index(sub.replace("_bn", "")), sub.endswith("_bn")
    pos = f"{i}.{int(bn)}" if sub.replace("_bn", "") != "project" else str(i + bn)
    return f"features.{int(block[5:]) + 1}.conv.{pos}"


def _mnasnet_name(path, siblings) -> str:
    """``l{i}`` -> ``layers.{i}``, ``l{i}_{r}/{conv,bn}{j}`` ->
    ``layers.{i}.{r}.layers.{j}``, ``classifier`` -> ``classifier.1``."""
    if path == ("classifier",):
        return "classifier.1"
    if len(path) == 1:
        return f"layers.{path[0][1:]}"
    i, r = path[0][1:].split("_")
    return f"layers.{i}.{r}.layers.{re.sub(r'\D', '', path[1])}"


def _shufflenet_name(path, siblings) -> str:
    """``conv{1,5}_{k}`` -> ``conv{1,5}.{k}``, ``stage{s}_{u}/b{b}_{i}`` ->
    ``stage{s}.{u}.branch{b}.{i}``, ``fc``."""
    if len(path) == 1:
        return path[0].replace("_", ".")
    unit, sub = path
    return f"{unit.replace('_', '.')}.branch{sub[1]}.{sub[3:]}"


def _densenet_name(path, siblings) -> str:
    """``stem``/``stem_bn`` -> ``features.conv0/norm0``,
    ``block{b}_layer{l}/{conv,bn}{k}`` ->
    ``features.denseblock{b+1}.denselayer{l+1}.{conv,norm}{k}``,
    ``trans{t}_{conv,bn}`` -> ``features.transition{t+1}.{conv,norm}``,
    ``final_bn`` -> ``features.norm5``, ``classifier``."""
    name = path[0]
    if name == "classifier":
        return name
    fixed = {"stem": "conv0", "stem_bn": "norm0", "final_bn": "norm5"}
    if name in fixed:
        return f"features.{fixed[name]}"
    m = re.fullmatch(r"trans(\d+)_(conv|bn)", name)
    if m:
        return f"features.transition{int(m.group(1)) + 1}." + (
            "conv" if m.group(2) == "conv" else "norm")
    b, l = re.fullmatch(r"block(\d+)_layer(\d+)", name).groups()
    return (f"features.denseblock{int(b) + 1}.denselayer{int(l) + 1}."
            + path[1].replace("bn", "norm"))


def _alexnet_name(path, siblings) -> str:
    """``f{i}`` -> ``features.{i}``; ``fc1``/``fc2``/``classifier`` ->
    ``classifier.{1,4,6}``."""
    name = path[0]
    return {"fc1": "classifier.1", "fc2": "classifier.4",
            "classifier": "classifier.6"}.get(name, f"features.{name[1:]}")


def _vgg_name(depth: int, bn: bool) -> Rename:
    """``conv{i}``/``bn{i}`` -> ``features.{index}`` at torchvision's
    Sequential indices (a conv, its BatchNorm, a ReLU; a max-pool takes one
    index); ``fc1``/``fc2``/``classifier`` -> ``classifier.{0,3,6}``, or
    ``classifier`` alone for the collapsed head."""
    at, seq, i = {}, 0, 0
    for v in VGG_CONFIGS[depth]:
        if v == "M":
            seq += 1
            continue
        at[f"conv{i}"] = seq
        if bn:
            at[f"bn{i}"] = seq + 1
        seq, i = seq + 2 + bn, i + 1

    def rename(path, siblings) -> str:
        name = path[0]
        if name in at:
            return f"features.{at[name]}"
        if "fc1" not in siblings:  # the collapsed head: the port's own key
            return "classifier"
        return {"fc1": "classifier.0", "fc2": "classifier.3", "classifier": "classifier.6"}[name]

    return rename


def _googlenet_name(path, siblings) -> str:
    """The torch attribute path; a Sequential index fused into its parent's
    name (``branch2_0``) is split again (``branch2.0``)."""
    return ".".join(re.sub(r"^(branch\d)_(\d)$", r"\1.\2", p) for p in path)


def _inception_name(path, siblings) -> str:
    """The torch attribute path (``Mixed_5b.branch5x5_1.conv``)."""
    return ".".join(path)


def _squeezenet_name(path, siblings) -> str:
    """``f{i}[/squeeze|expand1x1|expand3x3]`` -> ``features.{i}[...]``,
    ``classifier`` -> ``classifier.1``."""
    if path == ("classifier",):
        return "classifier.1"
    return ".".join([f"features.{path[0][1:]}", *path[1:]])


def _zoo_rename(arch: str):
    """The rename of ``arch``'s family, or None outside the zoo."""
    if arch.startswith("vgg"):
        m = re.fullmatch(r"vgg(11|13|16|19)(_bn)?", arch)
        return _vgg_name(int(m.group(1)), bool(m.group(2))) if m else None
    for prefix, rename in (("mobilenet_v2", _mobilenet_name), ("mnasnet", _mnasnet_name),
                           ("shufflenet_v2_", _shufflenet_name), ("densenet", _densenet_name),
                           ("alexnet", _alexnet_name), ("googlenet", _googlenet_name),
                           ("inception_v3", _inception_name), ("squeezenet", _squeezenet_name)):
        if arch.startswith(prefix):
            return rename
    return None


def _zoo_state_dict(params, stats, rename: Rename) -> Dict[str, np.ndarray]:
    """One walk over the flax tree: a conv kernel HWIO -> OIHW (its bias as
    it is), a Dense kernel ``[D, C]`` -> ``[C, D]``, a BatchNorm's four
    parts, each under ``rename(path, siblings)``."""
    out: Dict[str, np.ndarray] = {}

    def walk(p, s, path):
        for name, leaf in p.items():
            here = path + (name,)
            if "kernel" in leaf:
                key, kernel = rename(here, p), np.asarray(leaf["kernel"])
                out[f"{key}.weight"] = (np.transpose(kernel, (3, 2, 0, 1)) if kernel.ndim == 4
                                        else kernel.T)
                if "bias" in leaf:
                    out[f"{key}.bias"] = np.asarray(leaf["bias"])
            elif "scale" in leaf:
                key = rename(here, p)
                for flax_part, coll, torch_part in _BN_PARTS:
                    out[f"{key}.{torch_part}"] = np.asarray(
                        (leaf if coll == "params" else s[name])[flax_part])
            else:
                walk(leaf, s.get(name, {}), here)

    walk(params, stats, ())
    return out


# ---------------------------------------------------------------------------
# torch -> flax: the JAX package's variables from a torch state dict
# ---------------------------------------------------------------------------
#
# A key mapper takes one torch key to ``(collection, flax module path, kind)``,
# "skip" (a train-only aux head) or None (unmapped); kinds: ``conv`` (OIHW ->
# HWIO ``kernel``), ``linear-weight`` (``[C, D]`` -> ``kernel [D, C]``),
# ``linear-bias`` and ``bias`` (as they are), ``bn-<leaf>`` (scale, bias,
# mean, var). EfficientNet and ViT convert through a spec instead: the whole
# ordered key list of an instance, so a missing or extra key raises.

_TORCH_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
             "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _bn(path, part):
    """A BatchNorm part under ``path``, or None for a part flax has not
    (``num_batches_tracked``)."""
    if part not in _TORCH_BN:
        return None
    coll, leaf = _TORCH_BN[part]
    return coll, path, "bn-" + leaf


def _weight_or_bias(path, part, weight_kind="conv"):
    return ("params", path, weight_kind if part == "weight" else "bias")


def _resnet_key(key: str):
    """Both grammars (the reference's ``shortcut.N``/``linear``,
    torchvision's ``downsample.N``/``fc``) onto the flax ResNet's names."""
    if key in ("linear.weight", "linear.bias", "fc.weight", "fc.bias"):
        return "params", ("linear",), "linear-" + key.split(".")[1]
    if key == "conv1.weight":
        return "params", ("conv1",), "conv"
    m = re.fullmatch(r"bn1\.(\w+)", key)
    if m:
        return _bn(("bn1",), m.group(1))
    m = re.fullmatch(r"layer(\d+)\.(\d+)\.(.+)", key)
    if not m:
        return None
    block, rest = f"layer{m.group(1)}_{m.group(2)}", m.group(3)
    m = re.fullmatch(r"(conv\d)\.weight", rest)
    if m:
        return "params", (block, m.group(1)), "conv"
    m = re.fullmatch(r"(bn\d)\.(\w+)", rest)
    if m:
        return _bn((block, m.group(1)), m.group(2))
    m = re.fullmatch(r"(?:shortcut|downsample)\.([01])\.(\w+)", rest)
    if m and m.group(1) == "0":
        return ("params", (block, "shortcut_conv"), "conv") if m.group(2) == "weight" else None
    if m:
        return _bn((block, "shortcut_bn"), m.group(2))
    return None


def _wrn_key(key: str):
    """pytorchcv's WRN keys (and the JAX exporter's ``init_block.conv`` and
    ``identity_conv.conv``) onto the flax WRN's names."""
    if key in ("output.weight", "output.bias"):
        return "params", ("output",), "linear-" + key.split(".")[1]
    if key in ("features.init_block.weight", "features.init_block.conv.weight"):
        return "params", ("init_conv",), "conv"
    m = re.fullmatch(r"features\.post_activ\.bn\.(\w+)", key)
    if m:
        return _bn(("post_bn",), m.group(1))
    m = re.fullmatch(r"features\.stage(\d+)\.unit(\d+)\.(.+)", key)
    if not m:
        return None
    unit, rest = f"stage{m.group(1)}_unit{m.group(2)}", m.group(3)
    m = re.fullmatch(r"body\.conv(\d)\.conv\.weight", rest)
    if m:
        return "params", (unit, f"conv{m.group(1)}"), "conv"
    m = re.fullmatch(r"body\.conv(\d)\.bn\.(\w+)", rest)
    if m:
        return _bn((unit, f"bn{m.group(1)}"), m.group(2))
    if re.fullmatch(r"identity_conv(?:\.conv)?\.weight", rest):
        return "params", (unit, "identity_conv"), "conv"
    return None


def _squeezenet_key(key: str):
    """``features.{i}[.squeeze|expand1x1|expand3x3]``, ``classifier.1``."""
    m = re.fullmatch(r"features\.(\d+)(?:\.(squeeze|expand1x1|expand3x3))?\.(weight|bias)", key)
    if m:
        path = (f"f{m.group(1)}",) + ((m.group(2),) if m.group(2) else ())
        return _weight_or_bias(path, m.group(3))
    m = re.fullmatch(r"classifier\.1\.(weight|bias)", key)
    return _weight_or_bias(("classifier",), m.group(1)) if m else None


# the Sequential indices of a ShuffleNetV2 branch that are convs (the rest
# are BatchNorms; the ReLUs carry no weights)
_SHUFFLE_CONVS = {1: {0, 2}, 2: {0, 3, 5}}


def _conv_or_bn(path, part, is_conv: bool):
    """A bias-free conv's weight, or a BatchNorm part, under ``path``."""
    if is_conv:
        return ("params", path, "conv") if part == "weight" else None
    return _bn(path, part)


def _shufflenet_key(key: str):
    """``conv{1,5}.{0,1}``, ``stage{s}.{u}.branch{b}.{i}``, ``fc``."""
    if key in ("fc.weight", "fc.bias"):
        return "params", ("fc",), "linear-" + key.split(".")[1]
    m = re.fullmatch(r"conv([15])\.(\d)\.(\w+)", key)
    if m:
        return _conv_or_bn((f"conv{m.group(1)}_{m.group(2)}",), m.group(3), m.group(2) == "0")
    m = re.fullmatch(r"stage(\d)\.(\d+)\.branch(\d)\.(\d)\.(\w+)", key)
    if m:
        b, i = int(m.group(3)), int(m.group(4))
        return _conv_or_bn((f"stage{m.group(1)}_{m.group(2)}", f"b{b}_{i}"), m.group(5),
                           i in _SHUFFLE_CONVS[b])
    return None


def _densenet_key(key: str):
    """torchvision's ``features.{conv0,norm0,denseblock*,transition*,norm5}``
    and ``classifier`` onto stem/stem_bn, ``block{b}_layer{l}``,
    ``trans{t}_{conv,bn}``, final_bn, classifier (0-based)."""
    if key in ("classifier.weight", "classifier.bias"):
        return "params", ("classifier",), "linear-" + key.split(".")[1]
    if key == "features.conv0.weight":
        return "params", ("stem",), "conv"
    m = re.fullmatch(r"features\.norm([05])\.(\w+)", key)
    if m:
        return _bn(("stem_bn" if m.group(1) == "0" else "final_bn",), m.group(2))
    m = re.fullmatch(r"features\.denseblock(\d+)\.denselayer(\d+)\.(conv|norm)([12])\.(\w+)",
                     key)
    if m:
        block = f"block{int(m.group(1)) - 1}_layer{int(m.group(2)) - 1}"
        if m.group(3) == "conv":
            return ("params", (block, f"conv{m.group(4)}"), "conv") \
                if m.group(5) == "weight" else None
        return _bn((block, f"bn{m.group(4)}"), m.group(5))
    m = re.fullmatch(r"features\.transition(\d+)\.(conv|norm)\.(\w+)", key)
    if m:
        t = int(m.group(1)) - 1
        if m.group(2) == "conv":
            return ("params", (f"trans{t}_conv",), "conv") if m.group(3) == "weight" else None
        return _bn((f"trans{t}_bn",), m.group(3))
    return None


def _mobilenet_key(key: str):
    """torchvision's MobileNetV2: ``features.0`` stem, ``features.18``
    head, ``features.{1..17}.conv.*`` blocks (block 1, of expand ratio 1,
    has no expand pair), ``classifier.1``."""
    if key in ("classifier.1.weight", "classifier.1.bias"):
        return "params", ("classifier",), "linear-" + key.split(".")[2]
    m = re.fullmatch(r"features\.(0|18)\.([01])\.(\w+)", key)
    if m:
        name = {"0": "stem", "18": "head_conv"}[m.group(1)] if m.group(2) == "0" else \
            {"0": "stem_bn", "18": "head_bn"}[m.group(1)]
        return _conv_or_bn((name,), m.group(3), m.group(2) == "0")
    m = re.fullmatch(r"features\.(\d+)\.conv\.([\d.]+)\.(\w+)", key)
    if not m:
        return None
    t = int(m.group(1))
    layout = ({"0.0": "depthwise", "0.1": "depthwise_bn", "1": "project", "2": "project_bn"}
              if t == 1 else
              {"0.0": "expand", "0.1": "expand_bn", "1.0": "depthwise", "1.1": "depthwise_bn",
               "2": "project", "3": "project_bn"})
    name = layout.get(m.group(2))
    if name is None:
        return None
    return _conv_or_bn((f"block{t - 1}", name), m.group(3), not name.endswith("_bn"))


def _alexnet_key(key: str):
    """``features.{i}`` -> ``f{i}``; ``classifier.{1,4,6}`` -> fc1, fc2,
    classifier."""
    m = re.fullmatch(r"features\.(\d+)\.(weight|bias)", key)
    if m:
        return _weight_or_bias((f"f{m.group(1)}",), m.group(2))
    m = re.fullmatch(r"classifier\.([146])\.(weight|bias)", key)
    if m:
        return "params", ({"1": "fc1", "4": "fc2", "6": "classifier"}[m.group(1)],), \
            "linear-" + m.group(2)
    return None


def _vgg_key(depth: int, bn: bool):
    """torchvision's VGG Sequential indices (a conv, its BatchNorm, a ReLU;
    a max-pool takes one index) onto ``conv{i}``/``bn{i}``;
    ``classifier.{0,3,6}`` onto the classic head's fc1, fc2, classifier."""
    at, seq, i = {}, 0, 0
    for v in VGG_CONFIGS[depth]:
        if v == "M":
            seq += 1
            continue
        at[seq] = ("conv", i)
        if bn:
            at[seq + 1] = ("bn", i)
        seq, i = seq + 2 + bn, i + 1

    def mapper(key: str):
        m = re.fullmatch(r"features\.(\d+)\.(\w+)", key)
        if m:
            kind, i = at.get(int(m.group(1)), (None, None))
            if kind == "conv" and m.group(2) in ("weight", "bias"):
                return _weight_or_bias((f"conv{i}",), m.group(2))
            return _bn((f"bn{i}",), m.group(2)) if kind == "bn" else None
        m = re.fullmatch(r"classifier\.([036])\.(weight|bias)", key)
        if m:
            return "params", ({"0": "fc1", "3": "fc2", "6": "classifier"}[m.group(1)],), \
                "linear-" + m.group(2)
        return None

    return mapper


def _inception_key(key: str):
    """GoogLeNet and Inception v3: the torch attribute path, a Sequential
    index fused into its parent's name (``branch2.0`` -> ``branch2_0``);
    the aux heads are skipped."""
    if key.startswith(AUX_HEADS):
        return "skip"
    if key in ("fc.weight", "fc.bias"):
        return "params", ("fc",), "linear-" + key.split(".")[1]
    parts = key.split(".")
    if len(parts) < 3 or parts[-2] not in ("conv", "bn"):
        return None
    mods = []
    for p in parts[:-2]:
        if p.isdigit() and mods:
            mods[-1] += f"_{p}"
        else:
            mods.append(p)
    return _conv_or_bn(tuple(mods) + (parts[-2],), parts[-1], parts[-2] == "conv")


# MNASNet's ``layers``: convs at 0/3/6/14 (stem and head) and at 0/3/6 in a
# block; each BatchNorm right after its conv
_MNAS_STEM = {0: True, 3: True, 6: True, 14: True, 1: False, 4: False, 7: False, 15: False}
_MNAS_BLOCK = {0: True, 3: True, 6: True, 1: False, 4: False, 7: False}


def _mnasnet_key(key: str):
    """``layers.{i}[.{r}.layers.{j}]`` -> ``l{i}`` or ``l{i}_{r}/{conv,bn}{j}``;
    ``classifier.1``."""
    if key in ("classifier.1.weight", "classifier.1.bias"):
        return "params", ("classifier",), "linear-" + key.split(".")[2]
    m = re.fullmatch(r"layers\.(\d+)\.(\w+)", key)
    if m:
        i = int(m.group(1))
        return None if i not in _MNAS_STEM else _conv_or_bn((f"l{i}",), m.group(2),
                                                            _MNAS_STEM[i])
    m = re.fullmatch(r"layers\.(\d+)\.(\d+)\.layers\.(\d+)\.(\w+)", key)
    if m:
        j = int(m.group(3))
        if j in _MNAS_BLOCK:
            name = ("conv" if _MNAS_BLOCK[j] else "bn") + str(j)
            return _conv_or_bn((f"l{m.group(1)}_{m.group(2)}", name), m.group(4),
                               _MNAS_BLOCK[j])
    return None


# train-only auxiliary heads (GoogLeNet's aux1/aux2, Inception v3's AuxLogits)
AUX_HEADS = ("aux1.", "aux2.", "AuxLogits.")


def _key_mapper(arch: str):
    """The key mapper of ``arch``'s family; the ResNet mapper for any
    other name, as in the JAX package."""
    m = re.fullmatch(r"vgg(11|13|16|19)(_bn)?", arch)
    if m:
        return _vgg_key(int(m.group(1)), bool(m.group(2)))
    if arch in ("googlenet", "inception_v3"):
        return _inception_key
    for prefix, mapper in (("wrn28_10", _wrn_key), ("squeezenet1_", _squeezenet_key),
                           ("shufflenet_v2_", _shufflenet_key), ("densenet", _densenet_key),
                           ("mobilenet_v2", _mobilenet_key), ("alexnet", _alexnet_key),
                           ("mnasnet", _mnasnet_key)):
        if arch.startswith(prefix):
            return mapper
    return _resnet_key


def _efficientnet_spec(variant: str) -> list:
    """pytorchcv's EfficientNet keys, in order, each with its flax
    ``(collection, path, kind)``: the stem, every unit (a depthwise-
    separable unit where the expand ratio is 1, else an inverted residual;
    each with its squeeze-excite), the head conv and ``output.fc``."""
    _, dm, _, _ = EFFICIENTNET_COMPOUND[variant]
    entries = []

    def conv(key, *path):
        entries.append((key, "params", path + ("kernel",), "conv"))

    def conv_bn(key, conv_name, bn_name, *prefix):
        conv(f"{key}.conv.weight", *prefix, conv_name)
        for part, (coll, leaf) in _TORCH_BN.items():
            entries.append((f"{key}.bn.{part}", coll, prefix + (bn_name, leaf), "raw"))

    conv_bn("features.init_block.conv", "stem_conv", "stem_bn")
    repeats = [int(math.ceil(r * dm)) for _, _, r, _, _ in BASE_STAGES]
    for si, bi, key in pytorchcv_units(repeats):
        block = f"stage{si + 1}_block{bi + 1}"
        inverted = BASE_STAGES[si][0] != 1
        if inverted:
            conv_bn(f"{key}.conv1", "expand_conv", "expand_bn", block)
        conv_bn(f"{key}.conv2" if inverted else f"{key}.dw_conv", "dw_conv", "dw_bn", block)
        for torch_name, flax_name in (("conv1", "reduce"), ("conv2", "expand")):
            conv(f"{key}.se.{torch_name}.weight", block, "se", flax_name)
            entries.append((f"{key}.se.{torch_name}.bias", "params",
                            (block, "se", flax_name, "bias"), "raw"))
        conv_bn(f"{key}.conv3" if inverted else f"{key}.pw_conv", "project_conv", "project_bn",
                block)
    conv_bn("features.final_block", "head_conv", "head_bn")
    entries += [("output.fc.weight", "params", ("output", "kernel"), "linear"),
                ("output.fc.bias", "params", ("output", "bias"), "raw")]
    return entries


def _vit_spec(depth: int = 12) -> list:
    """torchvision's ViT keys, in order, each with its flax ``(collection,
    path, kind)``; the packed attention projections get the kinds
    ``qkv_w``, ``qkv_b`` and ``outproj_w``."""
    entries = [("conv_proj.weight", "params", ("patch_embed", "kernel"), "conv"),
               ("conv_proj.bias", "params", ("patch_embed", "bias"), "raw"),
               ("class_token", "params", ("cls",), "raw"),
               ("encoder.pos_embedding", "params", ("pos_embed",), "raw")]

    def affine(key, *path, kind="raw"):
        weight = "kernel" if kind == "linear" else "scale"
        entries.extend([(f"{key}.weight", "params", path + (weight,), kind),
                        (f"{key}.bias", "params", path + ("bias",), "raw")])

    for i in range(depth):
        key, block = f"encoder.layers.encoder_layer_{i}", f"block{i}"
        affine(f"{key}.ln_1", block, "ln1")
        attn = f"{key}.self_attention"
        entries += [(f"{attn}.in_proj_weight", "params", (block, "attn"), "qkv_w"),
                    (f"{attn}.in_proj_bias", "params", (block, "attn"), "qkv_b"),
                    (f"{attn}.out_proj.weight", "params", (block, "attn", "out", "kernel"),
                     "outproj_w"),
                    (f"{attn}.out_proj.bias", "params", (block, "attn", "out", "bias"), "raw")]
        affine(f"{key}.ln_2", block, "ln2")
        affine(f"{key}.mlp.0", block, "fc1", kind="linear")
        affine(f"{key}.mlp.3", block, "fc2", kind="linear")
    affine("encoder.ln", "ln")
    affine("heads.head", "output", kind="linear")
    return entries


def _spec(arch: str):
    """``(spec, attention heads)`` of a spec-converted arch, else None."""
    m = re.fullmatch(r"efficientnet_(b[0-8])[bc]?", arch)
    if m:
        return _efficientnet_spec(m.group(1)), 0
    if arch in ("vit_b16", "vit_s16"):
        return _vit_spec(), {"vit_s16": 6}.get(arch, 12)
    return None


def _put(tree: dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _spec_to_flax(state_dict, spec, heads: int) -> dict:
    variables: dict = {"params": {}, "batch_stats": {}}
    for key, coll, path, kind in spec:
        assert key in state_dict, f"checkpoint missing {key}"
        v, tree = _numpy(state_dict[key]), variables[coll]
        if kind == "conv":
            _put(tree, path, _hwio(v))
        elif kind == "linear":
            _put(tree, path, v.T)
        elif kind == "raw":
            _put(tree, path, v)
        elif kind == "qkv_w":  # [3D, D] -> per projection [D, H, hd]
            d = v.shape[1]
            for name, w in zip(("query", "key", "value"), np.split(v, 3, axis=0)):
                _put(tree, path + (name, "kernel"),
                     np.ascontiguousarray(w.T).reshape(d, heads, d // heads))
        elif kind == "qkv_b":  # [3D] -> per projection [H, hd]
            for name, b in zip(("query", "key", "value"), np.split(v, 3)):
                _put(tree, path + (name, "bias"), b.reshape(heads, -1))
        else:  # outproj_w: [D, D] -> [H, hd, D]
            d = v.shape[0]
            _put(tree, path, np.ascontiguousarray(v.T).reshape(heads, d // heads, d))
    names = {key for key, *_ in spec}
    leftovers = [k for k in state_dict if k not in names and not k.endswith("num_batches_tracked")]
    assert not leftovers, f"Unmapped checkpoint keys: {leftovers[:8]}"
    if not variables["batch_stats"]:
        variables.pop("batch_stats")
    return variables


def torch_state_dict_to_flax(state_dict, arch: str) -> dict:
    """The JAX package's variables ``{"params": ..., "batch_stats": ...}``
    (nested dicts of numpy arrays, equal to
    ``nbdt_tpu.models.convert.torch_state_dict_to_flax``'s, in its key
    order) of a flat torch state dict of ``arch``: conv weights OIHW ->
    HWIO, linear weights ``[C, D]`` -> ``[D, C]``, BatchNorm weight/bias
    -> scale/bias and running statistics -> ``batch_stats``. ``net`` or
    ``state_dict`` wrapping and ``module.`` prefixes are removed. A key that
    maps nowhere raises, so no weight is dropped unseen; GoogLeNet's and
    Inception v3's aux heads are skipped, with the JAX package's warning
    about ``transform_input``. The port's own collapsed VGG head and SegNet
    have no flax counterpart in the JAX converter and raise there too."""
    from .utils import coerce_state_dict

    if arch in ("googlenet", "inception_v3"):
        warnings.warn(
            f"torchvision pretrained {arch} checkpoints are trained with transform_input=True; "
            "build the Flax model with transform_input=True (e.g. models.googlenet(..., "
            "transform_input=True)) or its logits will differ.", stacklevel=2)
    state_dict = coerce_state_dict(state_dict)
    spec = _spec(arch)
    if spec is not None:
        return _spec_to_flax(state_dict, *spec)
    mapper = _key_mapper(arch)
    variables: dict = {"params": {}, "batch_stats": {}}
    unmapped = []
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        found = mapper(key)
        if found == "skip":
            continue
        if found is None:
            unmapped.append(key)
            continue
        coll, path, kind = found
        v = _numpy(value)
        if kind == "conv":
            _put(variables[coll], path + ("kernel",), _hwio(v))
        elif kind == "linear-weight":
            _put(variables[coll], path + ("kernel",), v.T)
        elif kind in ("linear-bias", "bias"):
            _put(variables[coll], path + ("bias",), v)
        else:  # bn-<leaf>
            _put(variables[coll], path + (kind[3:],), v)
    assert not unmapped, f"Unmapped checkpoint keys for arch {arch}: {unmapped}"
    if not variables["batch_stats"]:  # BatchNorm-free archs (AlexNet, plain VGG)
        variables.pop("batch_stats")
    return variables


def main(argv=None):
    """Checkpoint conversion CLI; the direction follows ``--out``'s
    extension:

        python -m nbdt_torch.models.convert ckpt.msgpack --arch ResNet18 --out ckpt.pth
        python -m nbdt_torch.models.convert ckpt.pth --arch ResNet18 --out ckpt.msgpack

    flax -> torch reads the JAX trainer's ``.msgpack`` (``{"params",
    "batch_stats"}``) and writes ``{"net": state_dict}``, which the port's
    module of ``--arch`` loads strictly; torch -> flax reads a reference-style
    ``.pth`` (``{"net": state_dict}`` or a bare state dict) and writes the
    bytes ``flax.serialization.to_bytes`` writes, with neither flax nor the
    ``msgpack`` package installed."""
    import argparse

    from ..serialization import read_msgpack, write_msgpack
    from .utils import load_torch_checkpoint

    parser = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    parser.add_argument("input")
    parser.add_argument("--arch", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    if args.out.endswith(".msgpack"):
        write_msgpack(args.out, torch_state_dict_to_flax(load_torch_checkpoint(args.input),
                                                         args.arch))
    elif args.out.endswith(".pth"):
        torch.save({"net": state_dict_from_flax(read_msgpack(args.input), args.arch)}, args.out)
    else:
        parser.error("--out must end in .msgpack (torch -> flax) or .pth (flax -> torch)")
    print(f"==> Wrote {args.out}")


if __name__ == "__main__":
    main()
