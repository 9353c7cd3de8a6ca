"""Flax variables -> the port's torch state dict (ResNet, WRN, EfficientNet
and ViT layouts).

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
``classifier.bias``.

``python -m nbdt_torch.models.convert ckpt.msgpack --arch A --out ckpt.pth``
converts a JAX checkpoint file, read without flax
(:mod:`nbdt_torch.serialization`).
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .efficientnet import BASE_STAGES, pytorchcv_units
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
    ``inception_v3``, ``squeezenet*``)."""
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
    else:
        raise NotImplementedError(
            f"state_dict_from_flax handles ResNet*, resnet*, resnext*, wide_resnet*, "
            f"wrn28_10*, WRN, efficientnet_*, EfficientNet, vit_b16, vit_s16, ViT and the "
            f"zoo's {', '.join(ZOO_PREFIXES)}, not {arch!r}")
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


def main(argv=None):
    """Checkpoint conversion CLI, flax -> torch:

        python -m nbdt_torch.models.convert ckpt.msgpack --arch ResNet18 --out ckpt.pth

    reads the JAX trainer's ``.msgpack`` (``{"params", "batch_stats"}``)
    and writes ``{"net": state_dict}``, which the port's module of
    ``--arch`` loads strictly. The torch -> flax direction (``--out
    ckpt.msgpack``) needs a msgpack writer and is not ported yet."""
    import argparse

    from ..serialization import read_msgpack

    parser = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    parser.add_argument("input")
    parser.add_argument("--arch", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    if args.out.endswith(".msgpack"):
        raise SystemExit("error: torch -> flax conversion is not ported to nbdt_torch yet "
                         "(ROADMAP A17); use python -m nbdt_tpu.models.convert")
    if not args.out.endswith(".pth"):
        parser.error("--out must end in .pth (flax -> torch)")
    torch.save({"net": state_dict_from_flax(read_msgpack(args.input), args.arch)}, args.out)
    print(f"==> Wrote {args.out}")


if __name__ == "__main__":
    main()
