"""nbdt_torch: Neural-Backed Decision Trees in PyTorch with CUDA kernels for
Hopper (H100).

A port of the JAX package ``nbdt_tpu``, which stays in the repository as its
reference. This package imports torch and never jax, flax or nbdt_tpu; it
reads the hierarchy JSONs and wnid lists vendored under ``nbdt_tpu/`` by
file path. Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.

  hierarchy/  host-side graph, wnid naming, classifier probe
  tree        host Tree + compilation to static arrays
  rules       soft and hard decision rules as plain PyTorch (exact f32)
  models      CIFAR ResNets and ViT-B/16, ViT-S/16 (NCHW), BN folding,
              flax -> torch converter, get_model
  ops         hand-written CUDA kernels (csrc/: soft head, LayerNorm) beside
              their plain versions
  model       NBDT / SoftNBDT / HardNBDT wrappers (NHWC input)
  serving     make_serving_fn
"""

__version__ = "0.1.0"

from .tree import Node, Tree, TreeArrays, dataset_to_dummy_classes
from .rules import (
    DeviceTreeArrays,
    EmbeddedDecisionRules,
    HardEmbeddedDecisionRules,
    SoftEmbeddedDecisionRules,
    to_device_tree,
)
from .model import NBDT, HardNBDT, SoftNBDT, TaggedOutput
from .serving import make_serving_fn
