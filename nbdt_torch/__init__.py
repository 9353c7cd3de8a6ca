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
  data/       CIFAR, ImageNet-folder, segmentation and synthetic datasets,
              label-subset wrappers, batch transforms, loaders
  native/     the host input pipeline's C++ kernels (augment, normalize,
              gather), built with g++ at first use
  trainer     TrainConfig, Trainer; main is the training CLI
  models      the backbones of the JAX registry (NCHW), BN folding, the
              flax -> torch converter, get_model; models.utils: released
              checkpoints through a local cache
  serialization  a pure-Python reader of the JAX package's .msgpack
              checkpoints
  ops         hand-written CUDA kernels (csrc/: soft head, LayerNorm, 3x3
              conv) beside their plain versions
  model       NBDT / SoftNBDT / HardNBDT wrappers (NHWC input), model_urls,
              and the per-pixel SegNBDT / SoftSegNBDT / HardSegNBDT
  serving     make_serving_fn; export_serving / load_serving (torch.export
              artifacts), aot_compile (torch.compile) and shard_serving
  parallel/   the process group, the (dp, tp) DeviceMesh, the cross-rank
              BatchNorm, ZeRO-1 (DDP training over one process per card)
  profiling   torch.profiler traces, step annotations, StepTimer
  bin/        the CLIs: nbdt, original, nbdt_export, nbdt_hierarchy,
              nbdt_wnids (installed as nbdt-torch, nbdt-torch-original,
              nbdt-torch-export, nbdt-torch-hierarchy, nbdt-torch-wnids)
  examples/   train_seg (the segmentation trainer), train_imagenet (the
              config-driven ImageNet trainer), load_pretrained and the
              load_pretrained_nbdts.ipynb walkthrough, vis_demo, app (an
              HTTP classifier)
  tools/      verify_release (released-checkpoint parity), count_work,
              the conv probe, the fused head's phase profiler, the conv
              ablation
  scripts/    the reproduction pipelines (bash and PowerShell)

The user guides are at the repository root: docs/torch/MIGRATION.md (from
upstream nbdt to this package, with runnable snippets), docs/torch/COVERAGE.md
(each upstream component, its module here and its test) and docs/torch/ZOO.md
(every --arch name, its key grammar and its converter).
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
from .model import (NBDT, HardNBDT, HardSegNBDT, SegNBDT, SoftNBDT, SoftSegNBDT, TaggedOutput,
                    model_urls)
from .losses import (
    CrossEntropyLoss,
    HardTreeSupLoss,
    SoftSegTreeSupLoss,
    SoftTreeLoss,
    SoftTreeSupLoss,
    TreeSupLoss,
    cross_entropy,
    hard_tree_sup_loss,
    soft_tree_sup_loss,
)
from .serving import (aot_compile, export_serving, load_serving, make_serving_fn,
                      shard_serving)
