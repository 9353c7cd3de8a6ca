"""Serving: the canonical serving forward, self-contained artifacts and
ahead-of-time compilation (counterpart of ``nbdt_tpu/serving.py``).

- :func:`make_serving_fn`: the serving forward (a bf16 backbone, f32 node
  decisions, the weights and tree constants held by the function).
- :func:`export_serving` / :func:`load_serving`: that forward as a
  ``torch.export`` program with a symbolic batch, saved to one file
  (conventionally ``.pt2``) that holds the weights and the tree constants.
  Loading it needs no model code, checkpoint or hierarchy JSON.
- :func:`aot_compile`: the same function through ``torch.compile`` for a
  fixed batch, compiled and warmed up before the first request.
- :func:`shard_serving`: a serving fn over a data-parallel mesh, each rank
  serving its rows of the global batch.

An exported or compiled program carries no matmul precision: the tree
products are plain matmuls in its graph (:func:`nbdt_torch.rules.exact_matmul`
does not switch the precision while it is traced). So :func:`load_serving`'s
and :func:`aot_compile`'s callables run the whole program under
:func:`~nbdt_torch.rules.exact_f32`, and a caller's TF32 setting never
reaches the node decisions. That covers the backbone's own f32 matmuls
too (a ResNet's classifier, a ViT's f32 GEMMs); its convolutions keep the
caller's cuDNN setting. A caller who runs an artifact through
``torch.export.load(path).module()`` directly must set
``torch.set_float32_matmul_precision("highest")`` itself.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from .data.transforms import CIFAR_MEAN, CIFAR_STD
from .models.fold import fold_batchnorm
from .models.layout import place_backbone
from .rules import DeviceTreeArrays, exact_f32, soft_forward, to_device_tree
from .utils import resolve_device

__all__ = ("ServingModule", "make_serving_fn", "export_serving", "load_serving", "aot_compile",
           "shard_serving")


class ServingModule(nn.Module):
    """``x [B,H,W,3] -> leaf probability distribution [B, C]``, the raw
    product of path probabilities (unnormalized; argmax is the
    prediction). The tree constants that the soft rules read are buffers,
    so an exported program holds them. The backbone is placed on their
    device by :func:`~nbdt_torch.models.layout.place_backbone`."""

    def __init__(self, backbone: nn.Module, jt: DeviceTreeArrays, bf16: bool, normalize=None):
        super().__init__()
        self.backbone, self.memory_format = place_backbone(backbone, jt.membership.device)
        self.bf16 = bf16
        self.uint8_input = normalize is not None
        self._jt = jt
        for name in ("membership", "under", "child_mask"):
            self.register_buffer(name, getattr(jt, name))
        if self.uint8_input:
            device = jt.membership.device
            mean = np.asarray(normalize[0], np.float32) * 255.0
            # (x/255 - m)/s == (x - m*255) * inv, with inv = 1/(s*255)
            inv = 1.0 / (np.asarray(normalize[1], np.float32) * 255.0)
            self.register_buffer("mean", torch.as_tensor(mean, device=device))
            self.register_buffer("inv", torch.as_tensor(inv, device=device))

    def forward(self, x):
        if self.uint8_input:
            # f32 affine, THEN the bf16 cast: the same rounding as the host
            # normalize + cast path
            x = (x.float() - self.mean) * self.inv
        if self.bf16:
            x = x.to(torch.bfloat16)
        logits = self.backbone(x.permute(0, 3, 1, 2).contiguous(memory_format=self.memory_format))
        jt = self._jt._replace(membership=self.membership, under=self.under,
                               child_mask=self.child_mask)
        return soft_forward(logits.float(), jt)


def serving_module(module: nn.Module, tree, bf16: bool = True, fold_bn: bool = False,
                   uint8_input: bool = False, normalize=None, device="cuda") -> ServingModule:
    """The :class:`ServingModule` of ``module`` on ``tree``, in eval mode on
    ``device`` in the layout of
    :func:`~nbdt_torch.models.layout.conv_memory_format` (channels-last for
    the bf16 default; see :func:`make_serving_fn` for the arguments)."""
    device = resolve_device(device)
    jt = to_device_tree(tree.arrays, device)
    backbone = module
    if fold_bn:
        backbone = fold_batchnorm(backbone)
    if bf16:
        source = backbone
        backbone = source.clone(dtype=torch.bfloat16)
        backbone.load_state_dict(source.state_dict())
    if uint8_input and normalize is None:
        normalize = (CIFAR_MEAN, CIFAR_STD)
    return ServingModule(backbone, jt, bf16, normalize if uint8_input else None).eval()


def make_serving_fn(
    module: nn.Module,
    tree,
    bf16: bool = True,
    fold_bn: bool = False,
    uint8_input: bool = False,
    normalize=None,
    device="cuda",
) -> Callable:
    """Build ``x [B,H,W,3] -> leaf probability distribution [B, C]``, the raw
    product of path probabilities (unnormalized; argmax is the prediction).

    ``module`` is a port backbone (a CIFAR or torchvision ResNet, ResNeXt or
    wide ResNet, a WRN, an EfficientNet, a ViT, or one of MobileNetV2,
    MNASNet, ShuffleNetV2, DenseNet, AlexNet, VGG, GoogLeNet, Inception v3
    and SqueezeNet) with ``dtype`` and ``clone(dtype=...)``. ``bf16`` runs
    it with a bfloat16 stream; node decisions always compute in f32.
    ``fold_bn`` folds BatchNorm into the conv weights first (the ResNet
    family; anything else, the EfficientNets and the rest of the zoo
    included, raises TypeError, as in the JAX package). ``uint8_input``
    accepts raw uint8 NHWC batches and normalizes on the device; ``normalize`` is ``(mean, std)`` in [0,1]
    units, the CIFAR constants by default. As in the JAX package this calls
    the plain rules (``soft_forward``), not the fused head.
    """
    device = resolve_device(device)
    serving = serving_module(module, tree, bf16, fold_bn, uint8_input, normalize, device)

    @torch.no_grad()
    def fn(x):
        return serving(torch.as_tensor(x, device=device))

    return fn


def export_serving(
    module: nn.Module,
    tree,
    path: str,
    image_size: int,
    bf16: bool = True,
    fold_bn: bool = False,
    uint8_input: bool = False,
    normalize=None,
    device="cuda",
) -> str:
    """Export the serving forward (:func:`make_serving_fn`'s, same
    arguments) with ``torch.export`` and save it to ``path``
    (conventionally ``.pt2``); returns ``path``. The batch dimension is
    symbolic (``torch.export.Dim.DYNAMIC``): one artifact serves every batch
    size its graph allows. That range is the graph's own: an f32 BatchNorm
    traced through cuDNN takes at most 65535 rows, a folded backbone has
    no bound. It is traced on ``device`` at a batch of 2, where neither 0
    nor 1 can specialise it. The artifact takes ``[b, image_size,
    image_size, 3]`` f32, or uint8 with ``uint8_input``. Load it with
    :func:`load_serving`."""
    device = resolve_device(device)
    serving = serving_module(module, tree, bf16, fold_bn, uint8_input, normalize, device)
    example = torch.zeros((2, image_size, image_size, 3),
                          dtype=torch.uint8 if uint8_input else torch.float32, device=device)
    program = torch.export.export(serving, (example,),
                                  dynamic_shapes=({0: torch.export.Dim.DYNAMIC},),
                                  strict=False)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return path


def load_serving(path: str, device="cuda") -> Callable:
    """Load an :func:`export_serving` artifact as ``x -> leaf probability
    distribution`` on ``device``, moved there if it was traced on another.
    Each call runs the program under ``torch.no_grad()`` and
    :func:`~nbdt_torch.rules.exact_f32` (see the module's docstring)."""
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    program = torch.export.load(path)
    target = torch.empty(0, device=device).device
    tensors = [*program.state_dict.values(), *program.constants.values()]
    if any(isinstance(t, torch.Tensor) and t.device != target for t in tensors):
        program = move_to_device_pass(program, target)
    forward = program.module()

    def fn(x):
        x = torch.as_tensor(x, device=device)
        with torch.no_grad(), exact_f32():
            return forward(x)

    return fn


def aot_compile(fn: Callable, batch: int, image_size: int, dtype=torch.float32,
                device="cuda") -> Callable:
    """Compile a serving fn (:func:`make_serving_fn`'s) with
    ``torch.compile`` for a fixed batch of ``[batch, image_size,
    image_size, 3]`` ``dtype`` images on ``device``, and run it once so
    that compilation leaves the first request. Every call, the warm-up
    included, runs under :func:`~nbdt_torch.rules.exact_f32`; the tree
    products then trace as plain matmuls and the soft rules stay one
    graph. Inductor's fused kernels round their intermediates to the stream
    dtype where the eager function does (``emulate_precision_casts``), so
    a bf16 backbone serves the live function's numbers."""
    device = resolve_device(device)
    # inductor keeps fused intermediates in f32 unless told to round them
    # where eager rounds: without it a bf16 backbone gives other numbers
    compiled = torch.compile(fn, dynamic=False, options={"emulate_precision_casts": True})

    def run(x):
        x = torch.as_tensor(x, device=device)
        with exact_f32():
            return compiled(x)

    run(torch.zeros((batch, image_size, image_size, 3), dtype=dtype, device=device))
    return run


def shard_serving(fn: Callable, mesh) -> Callable:
    """Data-parallel serving over a mesh (:func:`nbdt_torch.parallel.make_mesh`):
    every rank calls the returned function with the same global batch, runs
    ``fn`` on its dp rows and gathers the outputs, so each rank returns what
    ``fn`` returns on the whole batch (JAX's sharded output holds the global
    result). The batch must divide by the dp extent. At one rank it is
    ``fn``."""
    import torch.distributed as dist

    from .parallel import dp_rows

    dp = mesh.size(0)
    if dp == 1:
        return fn
    group = mesh.get_group("dp")
    nccl = dist.get_backend(group) == "nccl"

    def sharded(x):
        out = fn(x[dp_rows(mesh, x.shape[0])]).contiguous()
        if nccl:
            full = out.new_empty((out.shape[0] * dp, *out.shape[1:]))
            dist.all_gather_into_tensor(full, out, group=group)
            return full
        parts = [torch.empty_like(out) for _ in range(dp)]
        dist.all_gather(parts, out, group=group)  # gloo has no all_gather_into_tensor
        return torch.cat(parts)

    return sharded
