"""Backbones of the port: the CIFAR and torchvision ResNets, the WideResNets,
the EfficientNets, the ViTs, Swin-B, the rest of torchvision's zoo (MobileNetV2,
DenseNet, VGG, AlexNet, GoogLeNet, Inception v3, MNASNet, SqueezeNet,
ShuffleNetV2), the seg backbones (the seg trainer's SegNet, HRNetV2), BN
folding, the converter and the registry.

Counterpart of ``nbdt_tpu/models/__init__.py``: the registry is an explicit
dict of constructors ``arch -> (num_classes, dtype, **kw) -> nn.Module``
under the reference's names, every name of the JAX registry, and the port's own
``swin_b_w12_384``, which the JAX package lacks.
"""

from typing import Callable, Dict, Optional

import torch

from . import efficientnet as _efficientnet
from .convert import pytorchcv_wrn_keys, state_dict_from_flax
from .efficientnet import *  # noqa: F401,F403 (EfficientNet and the b0..b8 x {,b,c} grid)
from .fold import fold_batchnorm
from .layout import place_backbone
from .segnet import SegNet
from .hrnet import HRNetV2, hrnetv2_w48
from .resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet10,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext101_32x8d,
    wide_resnet50_2,
    wide_resnet101_2,
)
from .alexnet import AlexNet, alexnet
from .densenet import DenseNet, densenet121, densenet161, densenet169, densenet201
from .googlenet import GoogLeNet, googlenet
from .inception import InceptionV3, inception_v3
from .mnasnet import MNASNet, mnasnet0_5, mnasnet0_75, mnasnet1_0, mnasnet1_3
from .mobilenet import MobileNetV2, mobilenet_v2
from .shufflenet import (
    ShuffleNetV2,
    shufflenet_v2_x0_5,
    shufflenet_v2_x1_0,
    shufflenet_v2_x1_5,
    shufflenet_v2_x2_0,
)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .swin import SwinTransformer, swin_b_w12_384
from .vgg import VGG, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16, vgg16_bn, vgg19, vgg19_bn
from .vit import ViT, vit_b16, vit_s16
from .wideresnet import WRN, wrn28_10, wrn28_10_cifar10, wrn28_10_cifar100

MODEL_REGISTRY: Dict[str, Callable] = {
    "ResNet10": ResNet10,
    "ResNet18": ResNet18,
    "ResNet34": ResNet34,
    "ResNet50": ResNet50,
    "ResNet101": ResNet101,
    "ResNet152": ResNet152,
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "resnext50_32x4d": resnext50_32x4d,
    "resnext101_32x8d": resnext101_32x8d,
    "wide_resnet50_2": wide_resnet50_2,
    "wide_resnet101_2": wide_resnet101_2,
    "wrn28_10": wrn28_10,
    "wrn28_10_cifar10": wrn28_10_cifar10,
    "wrn28_10_cifar100": wrn28_10_cifar100,
    # the b0..b8 x {plain, "b" (TF-ported), "c" (AdvProp)} grid
    **{name: getattr(_efficientnet, name)
       for name in _efficientnet.__all__ if name != "EfficientNet"},
    "vit_b16": vit_b16,
    "vit_s16": vit_s16,
    "swin_b_w12_384": swin_b_w12_384,
    # the rest of torchvision's zoo, in the JAX registry's order
    "mobilenet_v2": mobilenet_v2,
    "densenet121": densenet121,
    "densenet161": densenet161,
    "densenet169": densenet169,
    "densenet201": densenet201,
    "vgg11": vgg11,
    "vgg13": vgg13,
    "vgg16": vgg16,
    "vgg19": vgg19,
    "vgg11_bn": vgg11_bn,
    "vgg13_bn": vgg13_bn,
    "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "googlenet": googlenet,
    "inception_v3": inception_v3,
    "mnasnet0_5": mnasnet0_5,
    "mnasnet0_75": mnasnet0_75,
    "mnasnet1_0": mnasnet1_0,
    "mnasnet1_3": mnasnet1_3,
    "squeezenet1_0": squeezenet1_0,
    "squeezenet1_1": squeezenet1_1,
    "shufflenet_v2_x0_5": shufflenet_v2_x0_5,
    "shufflenet_v2_x1_0": shufflenet_v2_x1_0,
    "shufflenet_v2_x1_5": shufflenet_v2_x1_5,
    "shufflenet_v2_x2_0": shufflenet_v2_x2_0,
    "WRN": WRN,
}


# Backbones built for one input resolution (their position embeddings, Swin's
# window grid); the convolutional ones take any.
FIXED_RESOLUTION = ("vit_b16", "vit_s16", "swin_b_w12_384")


def register_model(name: str, ctor: Optional[Callable] = None,
                   override: bool = False) -> Callable:
    """Register a backbone constructor ``ctor(num_classes, dtype) ->
    nn.Module`` under ``name``; the module takes NCHW input, has
    ``forward(x, features_only=False)`` and an ``nn.Linear`` (or 1x1
    ``nn.Conv2d``) classifier that hierarchy induction's probe finds (one of
    ``nbdt_torch.hierarchy.generate.CLASSIFIER_NAMES``). Re-registering a
    name raises unless ``override=True``: a silent replacement would send
    every later ``get_model`` (conversion, induction, the CLIs) to another
    backbone. Usable as a decorator::

        @register_model("yournet18")
        def yournet18(num_classes=10, dtype=torch.float32): ...
    """
    if ctor is None:
        return lambda fn: register_model(name, fn, override=override)
    if name in MODEL_REGISTRY and not override:
        raise ValueError(f"arch {name!r} is already registered; pass override=True to "
                         "replace it")
    MODEL_REGISTRY[name] = ctor
    return ctor


def get_model_choices():
    return sorted(MODEL_REGISTRY)


def get_model(arch: str, num_classes: int, dtype: torch.dtype = torch.float32,
              image_size: Optional[int] = None, **kw):
    """A backbone of the port by name (``MODEL_REGISTRY``); ``image_size``
    builds the ViTs and Swin for that input resolution (the others ignore
    it), and ``kw`` go to its constructor (``ln_impl`` for a ViT or Swin,
    ``attention_impl`` for a ViT, ``transform_input`` for googlenet and
    inception_v3, ``classic_head`` for a VGG)."""
    if arch not in MODEL_REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; the port has {get_model_choices()}")
    if image_size is not None and arch in FIXED_RESOLUTION:
        kw["image_size"] = image_size
    return MODEL_REGISTRY[arch](num_classes=num_classes, dtype=dtype, **kw)


def init_model(arch: str, num_classes: int, input_shape, seed: int = 0,
               dtype: torch.dtype = torch.float32, device="cuda"):
    """A backbone with its default init drawn from ``seed`` (the global CPU
    generator seeded inside a fork, so the caller's random state is left as
    it was), in eval mode on ``device`` with channels-last weights, the
    layout the trainer runs (an inference wrapper places it again by
    :func:`~nbdt_torch.models.layout.conv_memory_format`). ``input_shape``
    is one image ``(H, W, 3)``: it sizes the ViTs."""
    from ..utils import resolve_device

    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = get_model(arch, num_classes, dtype=dtype, image_size=input_shape[0])
    return module.to(device, memory_format=torch.channels_last).eval()


def make_eval_fn(module: torch.nn.Module, device="cuda"):
    """Eval-mode forward ``x [B, H, W, 3] -> logits`` under ``no_grad``, with
    the module moved to ``device`` in the layout of
    :func:`~nbdt_torch.models.layout.conv_memory_format`."""
    from ..utils import resolve_device

    device = resolve_device(device)
    module, memory_format = place_backbone(module, device)

    @torch.no_grad()
    def forward(x):
        x = torch.as_tensor(x, device=device).permute(0, 3, 1, 2)
        return module(x.contiguous(memory_format=memory_format))

    return forward
