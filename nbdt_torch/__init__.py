"""nbdt_torch: Neural-Backed Decision Trees in PyTorch with CUDA kernels for
Hopper (H100).

A port of the JAX package ``nbdt_tpu``, which stays in the repository as its
reference. This package imports torch and never jax, flax or nbdt_tpu; it
reads the hierarchy JSONs and wnid lists vendored under ``nbdt_tpu/`` by
file path. Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.

  hierarchy/  host-side graph, wnids and mini-corpora, classifier probe,
              induced, WordNet and random hierarchies (generate_hierarchy),
              the HTML visualiser
  tree        host Tree + compilation to static arrays
  rules       soft and hard decision rules as plain PyTorch (exact f32)
  losses      the tree-supervision losses
  analysis    the --analysis plugins, the zero-shot Superclass pair too
  data/       CIFAR, ImageNet-folder and synthetic datasets, label-subset
              wrappers, batch transforms, loaders
  trainer     TrainConfig, Trainer; main is the training CLI; bin/ holds
              the hierarchy and wnid CLIs
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
