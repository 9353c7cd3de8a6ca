#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nbdt_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths through its entry points, with seeded random
weights: soft-NBDT ResNet18 on the CIFAR10 induced hierarchy at batch 8192,
soft-NBDT ViT-B/16 (224px, 1000 classes, bf16 stream, the fused LayerNorm
kernel) on the Imagenet1000 induced hierarchy at batch 256, the 3x3 conv
probe (``nbdt_torch.tools.probe_pallas_conv``: ResNet18's L1 conv, 64 -> 64
channels at 32px, + bias + ReLU, bf16) at batch 8192, and tree-supervised
ResNet18 training on CIFAR10-shaped synthetic data at batch 512 (the
trainer's cached and host-fed modes, the three tree losses, a SoftTreeLoss
refresh, the CLI, save and resume, a card-vs-CPU step), and WideResNet-28-10
(serving CIFAR100 through the fused head at batch 1024; tree-supervised
training at batch 512 evaluated with the NBDT analyzers; the CLI on 64px
TinyImagenet200, then ``--eval --checkpoint-path --analysis``), and the
zero-shot flow with ViT-B/16 in f32 (the CLI trains on CIFAR10 at 32px
without two classes on the WordNet tree, then scores CIFAR100's classes with
the Superclass analyzers through a mini-corpus; the Trainer at 224px on 1000
classes with 100 unseen), and the ImageNet path (EfficientNet-B7b at 600px,
3 requests of 64, and resnet50 at 224px, 3 requests of 256, through the
fused head on the Imagenet1000 induced trees at D=2560 and D=2048, C=1000;
their bf16 serving fns; the CLI's ``--arch efficientnet_b7b --eval``), and the
zoo path (MobileNetV2, DenseNet-121, AlexNet, GoogLeNet, MNASNet-1.0, VGG-16-BN
with torchvision's head, ShuffleNetV2-x1.0 at 224px and Inception v3 at 299px,
3 requests of 256 each through the fused head on the Imagenet1000 induced tree
at D=1024, 1280, 2048 and 4096, C=1000, their classifiers found by the probe;
SqueezeNet-1.1 through the plain rules, its fused head refused; each bf16
serving fn; one forward of each of the zoo's 26 names; the CLI's ``--arch
mobilenet_v2 --eval``), and the export path (the ResNet18 serving fn as a
``torch.export`` artifact: loaded and run at batches 1, 7 and 8192, run by a
process with torch alone, its tree products exact under a caller's "medium"
precision; ``aot_compile`` at batch 8192 as one graph; the ``nbdt_export``
CLI on a seeded WRN-28-10 at 1024; that WRN found in the checkpoint cache
under its released name by the ``nbdt`` CLI's builder, with the decision
line and ``nbdt-original``'s prediction), and the parallel path (the training
path's ResNet18 at batch 512 on a one-rank NCCL mesh beside the plain
trainer, under ZeRO-1, through a ``.dcp`` directory checkpoint; two ranks
sharing the card over gloo against the plain trainer on the same global
batches, with ``shard_serving`` of the flagship serving fn at 8192; a
``--profile`` trace; the CLI's ``--mesh --zero``), and the segmentation path
(SoftSegNBDT and HardSegNBDT over the seg trainer's SegNet at 2,097,152
pixels a request: 150 classes at 512x512 on the ADE20K HRNet-w48 tree and 19
at 512x1024 on Cityscapes'; the seg trainer at PascalContext's shape, 59
classes at 480px, batch 8, and its CLI), and the ImageNet training path
(``python -m nbdt_torch.examples.train_imagenet`` on the resnet18 config at
224px, 1000 classes, batch 256 and on resnet50's; the first step card vs CPU;
the classifier split over two ranks sharing the card at ``--tp 2``), and the
host paths of the converter (torch -> msgpack -> torch) and the examples
(``load_pretrained``, the HTTP app on a free port, ``vis_demo``), and the
release path (``python -m nbdt_torch.tools.verify_release``, the
released-checkpoint parity harness, through its ``main`` on the four rows
of its published table: WRN-28-10 on CIFAR10, CIFAR100 and
TinyImagenet200 at 10,000 synthetic images each and EfficientNet-B7b on
Imagenet1000 at 224px on 1,024, from seeded checkpoints; its verdict
against its own numbers, the card against the CPU, the fused head held to
its soft argmax, ``--val real`` on a staged CIFAR10 test batch), and the
surface phase (the JAX package's last public names on the port, in a worker
with jax, flax, optax and nbdt_tpu blocked: the re-exported loss and
hierarchy names, ``Tree.create_from_args``, the Node helpers,
``Digraph.remove_node``, the embedded wnid tables; the notebook walkthrough
``nbdt_torch/examples/load_pretrained_nbdts.ipynb`` on the card against the
CPU; ``apply_augment_numpy`` against the native augment), and the docs
phase (every runnable snippet of the port's migration guide,
``docs/torch/MIGRATION.md``, on the card in a worker with the same imports
blocked: each snippet's wall time and decision path, and no kernel launch
unless a snippet asks for ``fused=True``), beside a native phase that holds the
host input pipeline's C++ kernels (``nbdt_torch.native``) against numpy and
checks that the host-fed training run went through them. Builds every
hand-written kernel from ``nbdt_torch/csrc/``, holds each against its plain
PyTorch version, checks each path's launch counts and outputs, and times the
kernels and requests with CUDA events. Exits nonzero, printing no result,
when there is no CUDA device or any check fails. The last line is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel JSON
record.

Phases: device, build, the conv probe's inputs, kernel vs plain (soft_head,
layernorm, conv3x3, bn_act), ResNet18 main path, its serving fn, ViT-B/16
main path, its f32 gate, its serving fn, the conv probe path (one request, then the
probe's parity and timing phases), the training path, the WRN-28-10 serving
and training path, the zero-shot path, the ImageNet path, the zoo path, the
export path, the parallel path, the segmentation path, the ImageNet
training path with its tp pair, the converter and examples, the release
path, the surface phase, the docs phase, times (dw_bn_swish's at B7b's
depthwise shapes among them) and the float64 witness; the native phase runs
after the training path.
"""

from __future__ import annotations

import contextlib
import copy
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from nbdt_torch import (HardNBDT, HardSegNBDT, SoftNBDT, SoftSegNBDT, aot_compile,
                        export_serving, load_serving, make_serving_fn, native)
from nbdt_torch import losses as tl
from nbdt_torch.analysis import HardEmbeddedDecisionRules as HardAnalyzer
from nbdt_torch.analysis import SoftEmbeddedDecisionRules as SoftAnalyzer
from nbdt_torch.data import (DataLoader, LearnableSyntheticDataset, PrefetchLoader,
                             SegDataLoader, SyntheticSegDataset)
from nbdt_torch.data.transforms import (CIFAR_MEAN, CIFAR_STD, IMAGENET_MEAN, IMAGENET_STD,
                                        augment_uint8, normalize)
from nbdt_torch.examples import load_pretrained, train_imagenet, train_seg, vis_demo
from nbdt_torch.hierarchy.digraph import Digraph
from nbdt_torch.hierarchy.generate import find_classifier
from nbdt_torch.main import main as train_cli
from nbdt_torch.models import ResNet18, SegNet, vit_b16, wrn28_10_cifar10, wrn28_10_cifar100
from nbdt_torch.models import efficientnet as efficientnet_module
from nbdt_torch.models import resnet as resnet_module
from nbdt_torch.ops import _build
from nbdt_torch.ops import bn_act as ba
from nbdt_torch.ops import conv3x3 as conv
from nbdt_torch.ops import dw_bn_swish as dw
from nbdt_torch.ops import layernorm as ln
from nbdt_torch.ops import soft_traversal as st
from nbdt_torch.rules import (HardEmbeddedDecisionRules, SoftEmbeddedDecisionRules,
                              get_all_node_outputs, soft_leaf_log_probs, to_device_tree)
from nbdt_torch.tools import probe_pallas_conv as probe
from nbdt_torch.tools import verify_release as vr
from nbdt_torch.tools.count_work import PEAK_BYTES_PER_S, PEAK_F32_FLOPS, head_bound_ms
from nbdt_torch.trainer import TrainConfig, Trainer, lr_schedule, make_optimizer, make_train_step
from nbdt_torch.tree import Tree

BATCH = 8192  # the flagship serving batch (bench.py's)
FEAT_DIM = 512  # ResNet18's pooled feature width
VIT_BATCH = 256  # tools/probe_vit.py's batch
VIT_IMG = 224
VIT_DIM = 768
VIT_CLASSES = 1000
VIT_LN_PER_REQUEST = 25  # 2 per block x 12 blocks + the final LayerNorm
BN_ACT_PER_REQUEST = 17  # ResNet18 in f32: the stem, 2 per BasicBlock x 8
PROBE_PARITY_BATCH = 64  # tools/probe_pallas_conv.py's --parity-batch
REQUESTS = 3
TIMED = 20
# W sets the head's timing rotates at the ViT shape: 17 f32 W of 3 MB are
# more than the 50 MB L2, so W comes from HBM, as inside a request.
HEAD_W_SETS = 17
# f32 tolerance of the head kernel vs its plain version: both sum in f32 in
# different orders over D=512 or 768 products and up to 17 path steps.
TOL = 1e-4
# Training path: ResNet18 at 32px, 10 classes, batch 512 (TrainConfig's and
# the reference's), 10240 training images (20 steps an epoch), 2048 test, a
# 2-epoch run of the reference's recipe (its schedule then drops lr 0.1 10x
# at step 0 and again at epoch 1; held at 0.1 from scratch, with no
# warm-up, the soft loss rose over 2 epochs in a CPU run at batch 256).
TRAIN_BATCH = 512
TRAIN_SIZE = 10240
TEST_SIZE = 2048
TRAIN_EPOCHS = 2
# Batch of the card-vs-CPU step (a CPU step of ResNet18 at 512 takes ~10 s).
XSTEP_BATCH = 64
# Relative tolerance of that step's loss: the same f32 step (TF32 off) on two
# devices sums its convolutions and reductions in other orders.
XSTEP_RTOL = 1e-4
# f32 tolerance of the LayerNorm kernel vs its plain version
# (tests/test_vit_variants.py's): the two sum a row of D values in f32 in
# different orders, and rsqrtf is within 2 ulp.
LN_TOL = 2e-5
# WRN-28-10 path: CIFAR100 at 32px (D=640 pooled features, C=100) on the
# vendored induced-wrn28_10_cifar100 tree. Serving: 3 requests of 1024
# images (5 timed). Training: batch 512, 4096 training images (8 steps an
# epoch) and 1024 test images, 2 epochs; the card-vs-CPU step at batch 8 (a
# CPU step of WRN-28-10 at 8 images takes seconds). The CLI: TinyImagenet200
# at 64px on the induced-wrn28_10 tree, batch 128 (--synthetic builds 4
# batches an epoch), 2 epochs.
WRN_BATCH = 1024
WRN_DIM = 640
WRN_CLASSES = 100
WRN_TIMED = 5
WRN_TRAIN_SIZE = 4096
WRN_TEST_SIZE = 1024
WRN_XSTEP_BATCH = 8
WRN_CLI_BATCH = 128
# Zero-shot path (ViT-B/16, f32, TF32 off, ln_impl="f32"). Z1/Z2: the CLI on
# CIFAR10 at 32px (--synthetic builds 4 batches of 256 to train and 2 to
# test), cat and dog (3, 5) unseen, 2 epochs on the vendored CIFAR10 WordNet
# tree, then a zero-shot eval on CIFAR100's classes in the superclass space
# of 'animal' and 'vehicle'. Z3: the Trainer at the published 224px on 1000
# classes, 600 synthetic images with labels 900-999 unseen (531 kept: 8
# cached steps of 64 an epoch), 2 epochs; the card-vs-CPU step at batch 2.
ZS_BATCH = 256
# Z1's learning rate. The 2-epoch schedule runs it /10, then /100. At the
# CLI's default 0.1, the mean loss of ViT-B/16 on --synthetic's noise images
# rose over the 2 epochs in a CPU run of this exact command (5.4929 ->
# 6.4118); at 0.01 it fell (4.7505 -> 4.6842).
ZS_LR = "0.01"
ZS_EXCLUDE = ("3", "5")
ZS_SUPERCLASSES = ("n00015388", "n04524313")  # 'animal', 'vehicle'
# Classes that map to those superclasses through the merged mini-corpus
# (tests/test_torch_hierarchy.py and tests/test_torch_analysis.py pin them
# against the JAX package): CIFAR10's prediction space, CIFAR100's test one.
ZS_MAPPED = {"CIFAR10": 8, "CIFAR100": 44}
Z3_BATCH = 64
Z3_SIZE = 600
Z3_STEPS = 8
Z3_XSTEP_BATCH = 2
# The bf16 serving fn against the f32 plain path: both round the same
# random-weight WRN differently (bf16 convs over 28 layers), so this is a
# floor on their argmax agreement, not an exactness gate.
WRN_BF16_AGREE = 0.9
# ImageNet path (BASELINE.json config #4 and ROADMAP A3), f32 with TF32 off,
# the Imagenet1000 induced trees (C=1000): EfficientNet-B7b at full width
# and depth (D=2560, 55 MBConv blocks) at its published 600px, 3 requests of
# 64 (4.83 TFLOP each, by nbdt_torch/tools/count_work.py); torchvision's
# resnet50 (D=2048) at 224px, 3 requests of 256 (2.09 TFLOP each). Each has
# 3 timed requests, and 16 images calibrate its BatchNorm statistics and its
# classifier. The CLI evaluates --synthetic Imagenet1000 (224px) at batch 32.
EFF_BATCH = 64
EFF_IMG = 600
EFF_DIM = 2560
# EfficientNet-B7b's depthwise convs at 600px: (channels, input side, k, stride,
# blocks) of each kind, TF "SAME" pads; one dw_bn_swish pass each
EFF_DW_SHAPES = ((64, 300, 3, 1, 1), (32, 300, 3, 1, 3), (192, 300, 3, 2, 1),
                 (288, 150, 3, 1, 6), (288, 150, 5, 2, 1), (480, 75, 5, 1, 6),
                 (480, 75, 3, 2, 1), (960, 38, 3, 1, 9), (960, 38, 5, 1, 1),
                 (1344, 38, 5, 1, 9), (1344, 38, 5, 2, 1), (2304, 19, 5, 1, 12),
                 (2304, 19, 3, 1, 1), (3840, 19, 3, 1, 3))
EFF_DW_PER_REQUEST = sum(shape[-1] for shape in EFF_DW_SHAPES)  # 55
R50_BATCH = 256
R50_IMG = 224
R50_DIM = 2048
R50_BN_ACT_PER_REQUEST = 49  # the stem, 3 per Bottleneck x 16
IMNET_CLASSES = 1000
IMNET_TIMED = 3
IMNET_CAL = 16
IMNET_CLI_BATCH = 32
# B1 on a path's head: 7 rotating copies of its f32 W (8-10 MB each) are
# more than the 50 MB L2, so W comes from HBM, as after a backbone's pass.
PATH_W_SETS = 7
# resnet50's folded serving fn against the unfolded f32 plain path (bench.py
# gates bf16-folded on argmax against f32): in f32, argmax 1.0 on rows whose
# top-2 gap exceeds TOL (the fold alone); in bf16, a floor on all rows. bf16
# rounding through 53 random-weight layers flips close rows: in a CPU run of
# these functions at 224px on 32 of these images, the unfolded bf16 backbone
# agreed with f32 on 0.78125 of rows and the folded bf16 one on 0.71875
# (top-1 leaf log-prob off by up to 0.76), while the f32 fold agreed on all
# (off by 1.2e-4). A broken fold or normalize agrees on about one row in the
# number of classes predicted (19 of those 32).
IMNET_BF16_AGREE = 0.5
# Zoo path (ROADMAP A14): the rest of torchvision's zoo at full width, f32
# with TF32 off, weights seeded and calibrated as the ImageNet path's, on the
# Imagenet1000 induced tree (C=1000): 3 requests of 256 each through
# SoftNBDT(fused=True) at 224px (Inception v3 at its published 299px), so B1
# runs at D=1024, 1280, 2048 and 4096; SqueezeNet-1.1, which has no pooled
# features, through the plain rules. Then one forward of each of the zoo's
# 26 names at batch 2 with its default init, and the CLI's --arch
# mobilenet_v2 --eval at batch 32.
ZOO_BATCH = 256
# calibrate_classifier's floor on the zoo's feature deviations: with none, a
# CPU run of these functions at their sizes (32 images) reached logits of
# 1.5e5 on VGG-16-BN's classic head and 1.2e3 on AlexNet's (hidden units dead
# on all 16 calibration images); at 0.1 the largest was 114 (Inception v3)
ZOO_SD_FLOOR = 0.1
ZOO_PATHS = (  # (arch, constructor keywords, image, pooled features)
    ("mobilenet_v2", {}, 224, 1280),
    ("densenet121", {}, 224, 1024),
    ("alexnet", {}, 224, 4096),
    ("googlenet", {}, 224, 1024),
    ("mnasnet1_0", {}, 224, 1280),
    ("vgg16_bn", {"classic_head": True}, 224, 4096),
    ("shufflenet_v2_x1_0", {}, 224, 1024),
    ("inception_v3", {}, 299, 2048),
)
ZOO_NAMES = ("mobilenet_v2", "densenet121", "densenet161", "densenet169", "densenet201",
             "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
             "alexnet", "googlenet", "inception_v3", "mnasnet0_5", "mnasnet0_75", "mnasnet1_0",
             "mnasnet1_3", "squeezenet1_0", "squeezenet1_1", "shufflenet_v2_x0_5",
             "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0")


# The export path (ROADMAP A12): the flagship artifact runs at these batches
# (1 and 7 off the traced batch of 2, then the serving batch); the f32
# artifact's exactness check takes EXPORT_EXACT_BATCH images; leaves that
# must be the same computation agree within EXPORT_TOL
EXPORT_BATCHES = (1, 7, BATCH)
EXPORT_EXACT_BATCH = 1024
EXPORT_TOL = 1e-6
# Parallel path (ROADMAP A13): config #2 at full width, cached, batch 512.
# (a)-(b) compare one epoch of TRAIN_SIZE and time the second of two; (d)
# two ranks on the one card take 256 rows each of PAR_STEPS global steps
# (PAR_STEPS * 512 images: one epoch); (e) traces 3 steps. The comparisons
# run with cuDNN's deterministic algorithms: with its default ones, two runs
# of the plain trainer part step by step (the (a) line prints how far),
# which no gate on the mesh could tell from its own error. Losses
# within PAR_RTOL of the plain trainer's (at one rank DDP and the cross-rank
# BatchNorm add no arithmetic; two ranks sum the gradient in two halves);
# running statistics within PAR_STATS_TOL after (d)'s first step. After more
# steps they are not gated: a ResNet's f32 gradient parts from its f64 value
# by a few tenths of a percent of its largest element, in one process as in
# two (tests/test_torch_parallel.py measures both on the CPU), and the
# updates carry that difference into the statistics.
PAR_STEPS = 4
PAR_RTOL = 1e-4
PAR_STATS_TOL = 1e-5
PAR_PROFILE_STEPS = 3
PAR_DEADLINE = 300  # seconds for (d)'s pair; a rank that dies kills its sibling
# Segmentation path (ROADMAP A16): the seg trainer's SegNet at its published
# widths, f32 with TF32 off, weights seeded and BatchNorm calibrated on the
# request. Serving through SoftSegNBDT and HardSegNBDT (the plain rules: seg
# refuses B1) on the vendored HRNet-w48 trees, 2,097,152 pixels a request:
# ADE20K (150 classes) at its 512 crop, batch 8, and Cityscapes (19) at its
# own 512x1024, batch 4. Gates on SEG_SAMPLE sampled pixels against the rules
# on the same class-map rows, and card vs CPU on a SEG_XDEV crop; soft
# within SEG_TOL (f32 leaf products summed in other orders); hard exact, a
# pixel excepted only where a node's two best children are closer than the
# node logits' own error (SEG_TIE on one device: the GEMM's order; twice the
# class maps' measured card-vs-CPU difference across devices), counted.
# Training: PascalContext's shape (59 classes, 520px images cropped to 480),
# batch 8, 2 epochs of 8 steps, lr 0.05 and tsw 1 (the CLI's defaults).
SEG_SERVE = (("ADE20K", "induced-HRNet-w48", 8, 512, 512),
             ("Cityscapes", "induced-HRNet-w48", 4, 512, 1024))
SEG_SAMPLE = 4096
SEG_XDEV = (2, 64, 96)
SEG_TOL = 1e-5
SEG_TIE = 1e-5
SEG_TIMED = 5
SEG_CLASSES, SEG_IMAGE, SEG_CROP, SEG_BATCH, SEG_STEPS = 59, 520, 480, 8, 8
SEG_LOSS_TOL = 1e-4  # the first step's loss, card vs CPU (the same f32 step)
# ImageNet training path (examples/imagenet/train.py's port, ROADMAP A13b):
# the resnet18 config at its width (224px, 1000 classes, batch 256) for 2
# epochs of the example's 2 synthetic steps, resnet50's for 1; card vs CPU
# on the first step at IMT_XSTEP_BATCH (a CPU step at 256 takes too long);
# the tp pair's 4 steps against a one-rank run with cuDNN deterministic
IMT_CONFIGS = Path(__file__).resolve().parent / "examples" / "imagenet" / "configs"
IMT_EPOCHS = 2
IMT_XSTEP_BATCH = 32
IMT_RTOL = 1e-4  # the first step's loss card vs CPU, and the tp ranks' against one rank
IMT_STATE_TOL = 1e-2  # the first step's update card vs CPU: L2 of the difference / of the update
IMT_DEADLINE = 150  # seconds for the tp pair; a rank that dies kills its sibling
# The tp pair's epochs (2 steps each): the config feeds raw 0-255 pixels at a
# peak rate of 0.4, so the loss grows step on step and f32 rounding of any two
# runs parts fast (a CPU rehearsal at 32px: 1.7e-6 at step 3, 1.7e-3 at 4);
# steps 1 and 2 hold the split forward and, after one update, its backward
IMT_TP_EPOCHS = 1
# Native phase (ROADMAP A10): the host kernels at the training path's batch
# of 32px CIFAR images; gather from a store of TRAIN_SIZE images
NATIVE_TOL = 1e-6  # tests/test_native.py's: the kernel normalizes through a table
NATIVE_TIMED = 20
# The host-fed ResNet18 step (epoch 1, device ms) when the loader ran numpy,
# on an H100 80GB HBM3 at 700 W (PERF.md section 5), printed beside this run's
NUMPY_HOST_FED_MS = 64.69
# Release path (``python -m nbdt_torch.tools.verify_release``, the port of
# tools/verify_release.py): the four rows of the tool's published table at
# their published widths, through its main(argv), f32 with TF32 off: (row,
# arch, dataset, synthetic val images on the card, images of the
# card-vs-CPU runs). R1-R3 take the size of the real val splits (10,000);
# R4 takes 1,024 of ImageNet's 50,000 (the tool transforms each image on
# the host, and 50,000 at 224px do not fit the time limit). The CPU runs
# take fewer images, since the CPU pays for them.
RELEASE_ROWS = (
    ("R1", "wrn28_10_cifar10", "CIFAR10", 10000, 256),
    ("R2", "wrn28_10_cifar100", "CIFAR100", 10000, 256),
    ("R3", "wrn28_10", "TinyImagenet200", 10000, 256),
    ("R4", "efficientnet_b7b", "Imagenet1000", 1024, 64),
)
RELEASE_BATCH = 512  # the tool's default
RELEASE_CAL = 64  # images that calibrate a seeded checkpoint's BatchNorm and classifier
RELEASE_REAL = 10000  # CIFAR10's test_batch, staged for --val real
RELEASE_CPU_THREADS = 6  # of the machine's 8 cores; the card's runs keep the rest
RELEASE_DEADLINE = 600  # seconds the CPU worker may take past the card's runs
# R3's checkpoint: the .pth that the WRN path's CLI trains on TinyImagenet200
WRN_CLI_PTH = Path(__file__).resolve().parent / "build" / "chip_smoke_wrn_cli.pth"
# Surface phase: the last public names of the JAX package on the port, in a
# worker with jax, jaxlib, flax, optax and nbdt_tpu blocked. The notebook
# walkthrough runs on the card (TF32 off) and on the CPU from one seeded
# ResNet18 .pth and PNG; each decision's prob within SURFACE_PROB_TOL (the
# test's, tests/test_torch_notebook.py). The numpy augment twin against the
# native kernel on a SURFACE_AUGMENT batch: the pixels it picks bit for bit,
# the floats within NATIVE_TOL.
SURFACE_NAMES = {
    "nbdt_torch": ["CrossEntropyLoss", "HardTreeSupLoss", "SoftSegTreeSupLoss", "SoftTreeLoss",
                   "SoftTreeSupLoss", "TreeSupLoss", "cross_entropy", "hard_tree_sup_loss",
                   "soft_tree_sup_loss"],
    "nbdt_torch.hierarchy": [
        "Digraph", "get_depth", "get_leaf_to_path", "get_leaves", "get_root", "get_roots",
        "node_link_data", "node_link_graph", "read_graph", "write_graph", "FakeSynset",
        "get_wnids", "get_wnids_from_dataset", "maybe_install_wordnet", "synset_to_name",
        "synset_to_wnid", "wnid_to_name", "wnid_to_synset", "wordnet_available", "write_wnids",
        "ward_children", "augment_graph", "build_induced_graph", "build_minimal_wordnet_graph",
        "build_random_graph", "prune_single_successor_nodes", "MODEL_FC_KEYS", "check_hierarchy",
        "generate_graph_fname", "generate_hierarchy", "get_centers_from_checkpoint",
        "get_centers_from_state_dict", "get_graph_path_from_args", "resolve_centers",
        "test_hierarchy"]}
SURFACE_PROB_TOL = 1e-4
SURFACE_AUGMENT = (256, 32, 32, 3)
SURFACE_TIMED = 20
SURFACE_DEADLINE = 300  # seconds for the worker
# The start of each worker's source: any import of jax, jaxlib, flax, optax
# or nbdt_tpu raises, so the worker shows the port runs without them.
BLOCKER_PRELUDE = r'''
import contextlib, io, json, os, sys, time
BLOCKED = ("jax", "jaxlib", "flax", "optax", "nbdt_tpu")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())
'''
SURFACE_WORKER = BLOCKER_PRELUDE + r'''
repo, pth, png, augment, timed = sys.argv[1:5] + [int(sys.argv[5])]
sys.path.insert(0, repo)
import argparse

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
rec = {}

# (a) every name of the slice, from the path a user writes
names = json.loads(sys.argv[6])
for module, listed in names.items():
    exec(f"from {module} import {', '.join(listed)}")
from nbdt_torch import assets
from nbdt_torch.assets import DATASET_TO_WNIDS, get_dataset_wnids
from nbdt_torch.bin.nbdt_hierarchy import main as hierarchy_main
from nbdt_torch.bin.nbdt_wnids import main as wnids_main
from nbdt_torch.data.transforms import CIFAR_MEAN, CIFAR_STD, apply_augment_numpy
from nbdt_torch.hierarchy import read_graph
from nbdt_torch.tree import Node, Tree

tree = Tree.create_from_args(argparse.Namespace(dataset="CIFAR100", path_graph=None,
                                                path_wnids=None, hierarchy="induced"))
root = tree.root
graph = read_graph(tree.path_graph)
inner = next(n for n in graph.nodes if graph.succ(n) and graph.pred(n))
parents, children = graph.pred(inner), graph.succ(inner)
graph.remove_node(inner)
vendored = {d: get_dataset_wnids(d) for d in DATASET_TO_WNIDS}
assets.dataset_to_default_path_wnids = lambda d: os.path.join(repo, "absent.txt")
rec["a"] = {
    "names": {module: len(listed) for module, listed in names.items()},
    "tables": {d: len(t) for d, t in DATASET_TO_WNIDS.items()},
    "tables_back_get_dataset_wnids": all(get_dataset_wnids(d) == t == vendored[d]
                                         for d, t in DATASET_TO_WNIDS.items()),
    "class_counts_root": root.class_counts, "dim_inodes": Node.dim(tree.inodes),
    "wnid_to_class_index": [root.wnid_to_class_index(w) for w in tree.wnids_leaves[:3]],
    "remove_node": inner not in graph and all(inner not in graph.succ(p) for p in parents)
    and all(inner not in graph.pred(c) for c in children),
    "console_mains": callable(hierarchy_main) and callable(wnids_main)}

# (b) the notebook walkthrough on the card, then on the CPU
nb = os.path.join(repo, "nbdt_torch", "examples", "load_pretrained_nbdts.ipynb")
with open(nb) as f:
    cells = ["".join(c["source"]) for c in json.load(f)["cells"] if c["cell_type"] == "code"]
code = compile("\n\n".join(cells), nb, "exec")
runs = {}
for device in ("cuda", "cpu"):
    os.environ.update(NBDT_DEVICE=device, NBDT_CHECKPOINT=pth, NBDT_IMAGE=png)
    ns, buf = {}, io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        exec(code, ns)
    runs[device] = {"ns": ns, "lines": buf.getvalue().splitlines(),
                    "seconds": time.perf_counter() - t0}
card, cpu = runs["cuda"]["ns"], runs["cpu"]["ns"]
model, x = card["model"], card["x"]
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
wall, event = [], []
for i in range(3 + timed):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    model.forward_with_decisions(x)
    end.record()
    torch.cuda.synchronize()
    if i >= 3:
        wall.append((time.perf_counter() - t0) * 1e3)
        event.append(start.elapsed_time(end))
rec["b"] = {
    "device": str(card["outputs"].device), "cpu_device": str(cpu["outputs"].device),
    "soft": [card["model"].tree.classes[int(ns["outputs"].argmax(-1)[0])] for ns in (card, cpu)],
    "hard": [card["model"].tree.classes[int(ns["h_out"].argmax(-1)[0])] for ns in (card, cpu)],
    "soft_nodes": [[s["name"] for s in ns["decisions"][0]] for ns in (card, cpu)],
    "hard_nodes": [[s["name"] for s in ns["h_dec"][0]] for ns in (card, cpu)],
    "prob_max_diff": max(abs(float(a["prob"]) - float(b["prob"])) for key in ("decisions", "h_dec")
                         for a, b in zip(card[key][0], cpu[key][0])),
    "lines": runs["cuda"]["lines"], "cpu_lines": runs["cpu"]["lines"],
    "seconds": runs["cuda"]["seconds"], "cpu_seconds": runs["cpu"]["seconds"],
    "ms": sorted(event)[timed // 2], "wall_ms": sorted(wall)[timed // 2], "timed": timed}

# (c) the numpy augment twin against the native kernel
from nbdt_torch import native

shape = tuple(int(v) for v in augment.split("x"))
batch = np.random.RandomState(91).randint(0, 256, shape).astype(np.uint8)
draws = np.random.RandomState(92)
ys = draws.randint(0, 9, size=shape[0])
xs = draws.randint(0, 9, size=shape[0])
flips = draws.rand(shape[0]) < 0.5
t0 = time.perf_counter()
twin = apply_augment_numpy(batch, 4, ys, xs, flips, CIFAR_MEAN, CIFAR_STD)
twin_ms = (time.perf_counter() - t0) * 1e3
t0 = time.perf_counter()
kernel = native.augment_batch(batch, 4, CIFAR_MEAN, CIFAR_STD, np.random.RandomState(92))
kernel_ms = (time.perf_counter() - t0) * 1e3
pixels = lambda v: np.rint((v * CIFAR_STD + CIFAR_MEAN) * 255).astype(np.uint8)
rec["c"] = {"shape": list(shape), "native": kernel is not None,
            "pixels_equal": kernel is not None and bool(np.array_equal(pixels(kernel), pixels(twin))),
            "max_abs_diff": None if kernel is None else float(np.abs(kernel - twin).max()),
            "twin_ms": twin_ms, "native_ms": kernel_ms, "native_calls": dict(native.calls)}

from nbdt_torch.ops import conv3x3, layernorm, soft_traversal

rec["launches"] = {"soft_head": soft_traversal.launches, "layernorm": layernorm.launches,
                   "conv3x3": conv3x3.launches}
rec["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps(rec))
'''
# Docs phase: every runnable snippet of the port's migration guide, on the
# default device, in a worker with the same imports blocked. The guide's
# scratch directory DOCS_SCRATCH moves under the phase's own.
DOCS_GUIDE = Path(__file__).resolve().parent / "docs" / "torch" / "MIGRATION.md"
DOCS_SCRATCH = "/tmp/nbdt_torch_mig"
DOCS_DEADLINE = 600  # seconds for the worker
DOCS_WORKER = BLOCKER_PRELUDE + r'''
repo, guide, marker, scratch, listing = sys.argv[1:6]
sys.path.insert(0, repo)
import torch

from nbdt_torch.ops import conv3x3, layernorm, soft_traversal

with open(listing) as f:
    runnable = json.load(f)
rec = {"snippets": []}
for i, block in runnable:
    code = compile(block.replace(marker, scratch), guide, "exec")
    soft_traversal.launches = layernorm.launches = conv3x3.launches = 0
    ns, buf = {"__name__": "__main__"}, io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        exec(code, ns)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"soft_head": soft_traversal.launches, "layernorm": layernorm.launches,
                "conv3x3": conv3x3.launches}
    decisions, outputs = ns.get("decisions"), ns.get("outputs")
    snippet = {"snippet": i, "seconds": seconds, "fused": "fused=True" in block,
               "device": ns.get("DEVICE"), "launches": launches,
               "outputs_device": None if outputs is None else str(outputs.device),
               "path": None if decisions is None else [d["name"] for d in decisions[0]],
               "lines": buf.getvalue().splitlines()}
    if snippet["fused"]:  # the B1 kernel against the plain rules on the snippet's images
        snippet["fused_max_abs_diff"] = float((ns["fused"](ns["x"]) - ns["plain"](ns["x"]))
                                              .abs().max())
    rec["snippets"].append(snippet)
rec["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps(rec))
'''


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def reset_launches() -> None:
    st.launches = ln.launches = conv.launches = ba.launches = dw.launches = 0


def read_launches() -> dict:
    return {"soft_head": st.launches, "layernorm": ln.launches, "conv3x3": conv.launches,
            "bn_act": ba.launches}


@contextlib.contextmanager
def library_passes():
    """The ResNet blocks' BatchNorm, residual add and ReLU, and EfficientNet's
    depthwise conv, BatchNorm and swish, as the library's passes
    (``bn_act_rule`` and ``dw_bn_swish_rule`` off) inside the block,
    whatever the call."""
    rules = resnet_module.bn_act_rule, efficientnet_module.dw_bn_swish_rule
    resnet_module.bn_act_rule = efficientnet_module.dw_bn_swish_rule = lambda *args: False
    try:
        yield
    finally:
        resnet_module.bn_act_rule, efficientnet_module.dw_bn_swish_rule = rules


class OnLibraryPasses:
    """An NBDT wrapper whose calls run under :func:`library_passes`: the
    plain side of a fused-vs-plain check, and its time, held to library
    code alone."""

    def __init__(self, nbdt):
        self.nbdt = nbdt

    def __call__(self, x):
        with library_passes():
            return self.nbdt(x)

    def forward_with_decisions(self, x):
        with library_passes():
            return self.nbdt.forward_with_decisions(x)


def synthetic_tree() -> Tree:
    """root -> (A, B, leaf6); A -> (leaf0, leaf1, leaf2); B -> (C, leaf5);
    C -> (leaf3, leaf4): three children at the root and at A."""
    G = Digraph()
    wnids = [f"f{i:08d}" for i in range(7)]
    for w in wnids:
        G.add_node(w, label=f"leaf{int(w[1:])}")
    for inner, label in [("i0", "root"), ("i1", "A"), ("i2", "B"), ("i3", "C")]:
        G.add_node(inner, label=label)
    for u, v in [("i0", "i1"), ("i0", "i2"), ("i0", wnids[6]), ("i1", wnids[0]),
                 ("i1", wnids[1]), ("i1", wnids[2]), ("i2", "i3"), ("i2", wnids[5]),
                 ("i3", wnids[3]), ("i3", wnids[4])]:
        G.add_edge(u, v)
    return Tree.from_graph(G, wnids)


def grouped_tree(C: int, K: int, dag: bool = False) -> Tree:
    """C leaves grouped K at a time, level by level, up to one root (a lone
    node at the end of a level moves up as it is). With ``dag``, every 7th
    leaf also hangs under the parent of the leaf K places on: two paths."""
    G = Digraph()
    leaves = [f"f{i:08d}" for i in range(C)]
    for i, w in enumerate(leaves):
        G.add_node(w, label=f"leaf{i}")
    parent, level, n = {}, list(leaves), 0
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), K):
            group = level[i:i + K]
            if len(group) == 1:
                nxt.append(group[0])
                continue
            inner = f"n{n:07d}"
            n += 1
            G.add_node(inner, label=inner)
            for child in group:
                G.add_edge(inner, child)
                parent[child] = inner
            nxt.append(inner)
        level = nxt
    if dag:
        for i in range(0, C, 7):
            other = parent[leaves[(i + K) % C]]
            if other != parent[leaves[i]]:
                G.add_edge(other, leaves[i])
    return Tree.from_graph(G, leaves)


def argmax_agreement(got: torch.Tensor, want: torch.Tensor, tol: float):
    """(agreement on rows whose reference top-2 gap exceeds tol, number of
    rows excluded as ties within tol, raw agreement)."""
    top2 = want.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > tol
    same = got.argmax(1) == want.argmax(1)
    n_decided = int(decided.sum())
    agree = float(same[decided].float().mean()) if n_decided else 1.0
    return agree, int((~decided).sum()), float(same.float().mean())


def time_cuda(fn, n: int = TIMED, warmup: int = 3) -> float:
    """Mean device ms per call over n back-to-back calls, CUDA events, after
    warm-up. A GPU-side sleep first lets the host queue all n calls, so host
    launch overhead does not open gaps between them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms of GPU clock cycles
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def wall_ms(fn, n: int = TIMED, warmup: int = 3) -> float:
    """Host-clock ms per call over n calls ending in a synchronize: what a
    caller waits, host overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def profile_ms(fn, n: int = TIMED) -> tuple:
    """torch.profiler over n calls: (wall ms per call, {kernel name: device
    ms per call}, {aten op: device ms per call of the kernels it launched},
    {kernel name: instances the profiler recorded over the n calls}). The
    dicts are empty if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    device, ops, seen = {}, {}, {}
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False):
            continue  # a span's range on the device timeline, not a kernel
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total:
            device[e.key] = e.self_device_time_total / n / 1e3
            seen[e.key] = e.count
        elif e.key.startswith("aten::") and e.self_device_time_total:
            ops[e.key] = e.self_device_time_total / n / 1e3
    return wall, device, ops, seen


def print_profile(label: str, wall: float, device: dict, ops: dict, seen: dict) -> None:
    busy = sum(device.values())
    # kernels whose names share their first 60 characters are summed as one
    ms, count = {}, {}
    for k, v in device.items():
        ms[k[:60]] = ms.get(k[:60], 0.0) + v
        count[k[:60]] = count.get(k[:60], 0) + seen[k]
    top = sorted(ms.items(), key=lambda kv: -kv[1])[:6]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
    print(f"[times] {label} under the profiler: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms (idle share {1 - busy / wall:.4f}); top kernels "
          f"{json.dumps({k: round(v, 4) for k, v in top})}; their instances recorded "
          f"{json.dumps({k: count[k] for k, _ in top})}; device ms by aten op "
          f"{json.dumps({k: round(v, 4) for k, v in top_ops})}", flush=True)


def ptxas_report(name: str) -> list:
    """ptxas registers and spills of each kernel instance of a library, one
    line each."""
    entry, out = None, []
    for line in _build.build_logs.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spills = m.group(1), ""
            continue
        if entry and "spill" in line:
            spills = line.strip()
        if entry and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{entry}: {regs} registers; {spills}")
            entry = None
    return out


def head_inputs(ta, batch: int, dim: int, seed: int):
    """Post-ReLU pooled features and a classifier at init scale."""
    rng = np.random.RandomState(seed)
    feats = np.abs(rng.randn(batch, dim)).astype(np.float32)
    W = (rng.randn(dim, ta.num_classes) / math.sqrt(dim)).astype(np.float32)
    b = (0.1 * rng.randn(ta.num_classes)).astype(np.float32)
    return torch.as_tensor(feats, device="cuda"), W, b


def ln_bound_ms(x: torch.Tensor) -> tuple:
    """Least time for the LayerNorm on an H100: x read once, y written once,
    weight and bias read once, vs its f32 operations (sum, centre, square-
    accumulate, scale, affine: 8 per element) at the f32 peak."""
    D = x.shape[-1]
    nbytes = 2 * x.numel() * x.element_size() + 2 * D * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 8 * x.numel() / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def randomize_batchnorm(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded BatchNorm affine and running statistics, so that random-init
    predictions spread over the classes."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)


def calibrate_classifier(model, classifier, x: torch.Tensor, gen: torch.Generator,
                         sd_floor: float = 0.0) -> None:
    """Seeded classifier over standardized features. Random weights map
    every image to nearly the same pooled features, so a plain random head
    predicts one class for all; centring and scaling by a calibration
    batch's feature statistics spreads the logits like a trained head's.
    ``sd_floor`` adds that share of the mean standard deviation to each
    feature's in quadrature (``hypot``, so 0 leaves them as they are): a
    feature near constant over the calibration batch (a unit of a hidden
    layer that no calibration image switches on) then gets no weight that
    lifts the logits of other images to thousands. A 1x1 conv classifier
    (SqueezeNet's, whose ReLU and mean over positions follow it) is centred
    on the map it takes and each class's row scaled to unit spread over
    images and positions, so that no class wins every image by the width of
    its ReLU's input alone."""
    with torch.no_grad():
        C, D = classifier.weight.shape[:2]
        w = torch.randn(C, D, generator=gen).to(x.device)
        if isinstance(classifier, torch.nn.Conv2d):
            fmap = model.features(x.permute(0, 3, 1, 2)).float()
            feats = fmap.permute(0, 2, 3, 1).reshape(-1, D)
            mu = feats.mean(0)
            w = w / (((feats - mu) @ w.T).std(0) + 1e-6)[:, None]
        else:
            feats = model(x.permute(0, 3, 1, 2), features_only=True)
            sd = feats.std(0)
            mu, sd = feats.mean(0), torch.hypot(sd, sd_floor * sd.mean()) + 1e-6
            w = w * (3.0 / math.sqrt(D)) / sd
        classifier.weight.copy_(w.view_as(classifier.weight))
        classifier.bias.copy_(-(w @ mu))


def variant(model, **kw):
    """The same weights under other knobs (dtype, ln_impl), on the card."""
    m = model.clone(**kw)
    m.load_state_dict(model.state_dict())
    return m.to("cuda").eval()


def gate_soft_head(feats: torch.Tensor, hc: st.HeadConstants, want_aux: bool,
                   case: str, tag: str = "[kernel]", exact: bool = False) -> float:
    """B1 vs its plain version on the same feats: f32 W within TOL on the
    leaf log-probs (and the aux logits and valid-slot log-probs), bf16 W
    within 1e-2 relative on the leaf probabilities, argmax 1.0 on rows whose
    plain top-2 gap exceeds TOL. With ``exact`` (an f32 W on a path's own
    features, whose classifier may cancel large terms), each f32 output is
    instead held to the same function evaluated in f64, within the plain
    version's own error against it plus TOL: the kernel no less exact than
    its plain version. Prints the instance and cluster size that ran.
    Returns the leaf max-abs error against the plain version."""
    got = st.fused_soft_head(feats, hc, want_aux=want_aux)
    want = st.soft_head_reference(feats, hc, want_aux=want_aux)
    exact = exact and hc.W.dtype == torch.float32
    if exact:
        ref = st.soft_head_reference(feats, hc, want_aux=want_aux, dtype=torch.float64)
        with st.exact_f32():
            scale = float((feats.float().abs() @ hc.W.abs() + hc.b.abs()).max())
    torch.cuda.synchronize()

    def within(i: int, what: str, mask=None) -> str:
        """Gate output i; returns its error report."""
        g, w = (got[i], want[i]) if mask is None else (got[i][:, mask], want[i][:, mask])
        err = float((g - w).abs().max())
        if not exact:
            check(err <= TOL, f"{case}: {what} max-abs error {err:.3g} > {TOL}")
            return f"{err:.3g}"
        r = ref[i] if mask is None else ref[i][:, mask]
        e_k, e_p = float((g.double() - r).abs().max()), float((w.double() - r).abs().max())
        check(e_k <= e_p + TOL, f"{case}: {what} kernel error against f64 {e_k:.3g} > the "
                                f"plain version's {e_p:.3g} + {TOL}")
        return f"{err:.3g} (against f64: kernel {e_k:.3g}, plain {e_p:.3g})"

    plan = st.last_launch["plan"]
    lib = st._library()
    smem = lib.nbdt_soft_head_smem_bytes(
        int(plan.instance == "cluster"), feats.shape[1], hc.num_classes,
        hc.num_nodes * hc.max_children, hc.slot_cls.numel(), hc.class_slot.numel(),
        int(hc.W.dtype == torch.bfloat16), plan.rows, plan.q, plan.class_slice, plan.stages)
    check(smem == plan.smem_bytes, f"{case}: plan says {plan.smem_bytes} bytes of shared "
                                   f"memory, the kernel {smem}")
    check(all(bool(torch.isfinite(g).all()) for g in got), f"{case}: non-finite output")
    err = float((got[0] - want[0]).abs().max())
    leaf = f"{err:.3g}"
    if hc.W.dtype == torch.float32:
        leaf = within(0, "leaf")
    else:
        check(torch.allclose(got[0].exp(), want[0].exp(), rtol=1e-2, atol=1e-4),
              f"{case}: leaf probabilities beyond 1e-2 relative")
    agree, ties, raw = argmax_agreement(got[0], want[0], TOL)
    check(agree == 1.0, f"{case}: argmax agreement {agree}")
    line = (f"{tag} {case} [{plan.instance} q={plan.q} rows={plan.rows} stages={plan.stages} "
            f"lists in smem={plan.lists_in_smem} grid="
            f"{st.last_launch['grid']} resident={st.last_launch['resident']}]: leaf err "
            f"{leaf}, argmax {agree} ({ties} tie rows within {TOL}, raw {raw})")
    if exact:
        line += f", classifier scale max(|feats| @ |W| + |b|) {scale:.4g}"
    if want_aux:
        valid = hc.slot_valid.bool()
        lerr = within(1, "aux logits")
        perr = within(2, "valid-slot log-probs", valid)
        check(bool((got[2][:, ~valid] == st.NEG).all()), f"{case}: padded slots not -1e30")
        line += f", logits err {lerr}, logp err {perr}"
    print(line, flush=True)
    instances_seen.add(plan.instance)
    return err


instances_seen: set = set()  # B1 instances that ran in the kernel gates


def check_soft_head_kernel(trees: dict, wrn_trees: dict) -> float:
    """B1 vs its plain version: at B=8192, D=512 on four trees and at the
    ViT head's shape (B=256, D=768) on Imagenet1000; ragged B (1, 17, 259)
    at both instances; C = 32 and 33, on either side of the plan's switch
    (K=2 and K=3); C = 300 (3 ranks), 1500 (two classifier passes a rank)
    and 3000 (the lists left in global memory); a DAG at each instance;
    D=100 (bf16 W then takes the cluster instance with unvectorized feats);
    the wide heads D=2048 (CIFAR100 at B=8192, Imagenet1000 at B=256) and
    D=2560 (TinyImagenet200 at B=259); WRN-28-10's heads (B=1024, D=640 on
    the CIFAR100 and TinyImagenet200 induced-wrn28_10 trees: C=100 and
    200). f32 and bf16 W, aux on and off.
    Checks that both instances ran. Returns the largest leaf max-abs
    error."""
    cases = [(name, tree, BATCH, FEAT_DIM) for name, tree in trees.items()]
    cases.append(("Imagenet1000", trees["Imagenet1000"], VIT_BATCH, VIT_DIM))
    for b in (1, 17, 259):
        cases.append(("CIFAR10", trees["CIFAR10"], b, FEAT_DIM))
        cases.append(("Imagenet1000", trees["Imagenet1000"], b, VIT_DIM))
    cases += [("grouped C=32 K=2", grouped_tree(32, 2), 259, FEAT_DIM),
              ("grouped C=33 K=3", grouped_tree(33, 3), 259, FEAT_DIM),
              ("grouped C=300 K=3", grouped_tree(300, 3), 259, FEAT_DIM),
              ("grouped C=1500 K=2", grouped_tree(1500, 2), 259, FEAT_DIM),
              ("grouped C=3000 K=2", grouped_tree(3000, 2), 37, VIT_DIM),
              # wide heads the cluster instance once refused (C1): ResNet50's
              # D=2048, EfficientNet-B7's 2560, at a ragged batch
              ("CIFAR100", trees["CIFAR100"], BATCH, 2048),
              ("Imagenet1000", trees["Imagenet1000"], VIT_BATCH, 2048),
              ("TinyImagenet200", trees["TinyImagenet200"], 259, 2560),
              ("DAG C=3", grouped_tree(3, 2, dag=True), 17, FEAT_DIM),
              ("DAG C=40", grouped_tree(40, 2, dag=True), 259, FEAT_DIM),
              ("CIFAR10", trees["CIFAR10"], 17, 100)]
    cases += [(name, tree, WRN_BATCH, WRN_DIM) for name, tree in wrn_trees.items()]
    max_err = 0.0
    for seed, (tname, tree, batch, dim) in enumerate(cases):
        ta = tree.arrays
        feats, W, b = head_inputs(ta, batch, dim, seed)
        for dtype in (torch.float32, torch.bfloat16):
            hc = st.prepare_head_constants(ta, W, b, dtype=dtype)
            for want_aux in (True, False):
                case = f"{tname} B={batch} D={dim} W={str(dtype)[6:]} aux={want_aux}"
                max_err = max(max_err, gate_soft_head(feats.to(dtype), hc, want_aux, case))
    check(instances_seen == {"stream", "cluster"},
          f"soft_head instances that ran: {sorted(instances_seen)}")
    return max_err


def check_layernorm_kernel() -> dict:
    """B2 vs its plain version: the ViT-B shape, an odd row count, and a row
    too wide for registers (the streamed instance), f32 and bf16. Returns the
    largest max-abs error per dtype."""
    g = torch.Generator(device="cuda").manual_seed(2)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for rows, D in ((VIT_BATCH * 197, VIT_DIM), (257, 384), (129, 4096)):
        # residual-stream-like rows: a nonzero mean and spread per row
        x = (torch.randn(rows, D, device="cuda", generator=g) * 2
             + torch.randn(rows, 1, device="cuda", generator=g))
        w = 1 + 0.1 * torch.randn(D, device="cuda", generator=g)
        b = 0.1 * torch.randn(D, device="cuda", generator=g)
        for dtype in errs:
            xd = x.to(dtype)
            got = ln.fused_layernorm(xd, w, b)
            want = ln.layernorm_reference(xd, w, b)
            torch.cuda.synchronize()
            case = f"layernorm rows={rows} D={D} {str(dtype)[6:]}"
            check(got.dtype == dtype and got.shape == xd.shape, f"{case}: dtype/shape")
            check(bool(torch.isfinite(got).all()), f"{case}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            errs[dtype] = max(errs[dtype], err)
            if dtype == torch.float32:
                check(torch.allclose(got, want, rtol=LN_TOL, atol=LN_TOL),
                      f"{case}: beyond rtol=atol={LN_TOL} (max-abs {err:.3g})")
            else:
                torch.testing.assert_close(got, want, msg=lambda m: f"{case}: {m}")
            print(f"[kernel] {case}: max-abs err {err:.3g}", flush=True)
    return errs


# The shapes bn_act takes on the main paths: ResNet18's first and last stages
# at 8192 images, HRNetV2-W48's four branches at 32
BN_ACT_CHECK_SHAPES = ((BATCH, 64, 32, 32), (BATCH, 512, 4, 4), (32, 48, 130, 130),
                       (32, 96, 65, 65), (32, 192, 33, 33), (32, 384, 17, 17))


def check_bn_act_kernel() -> int:
    """bn_act vs its plain version, bit for bit, at BN_ACT_CHECK_SHAPES in
    each variant: no residual (a block's first conv), the block's input,
    and the shortcut conv's output through its own BatchNorm. Returns the
    number of cases."""
    g = torch.Generator(device="cuda").manual_seed(13)
    cases = 0
    for shape in BN_ACT_CHECK_SHAPES:
        bn, rbn = seeded_bn(shape[1], g), seeded_bn(shape[1], g)
        x = 3 * torch.randn(shape, device="cuda", generator=g) + 0.5
        r = 2 * torch.randn(shape, device="cuda", generator=g)
        for variant, residual, shortcut_bn in (("none", None, None), ("residual", r, None),
                                               ("residual+bn", r, rbn)):
            with torch.no_grad():
                want = ba.bn_act_reference(x, bn, residual, shortcut_bn)
                got = ba.fused_bn_act(x.clone(), bn, residual, shortcut_bn)
            torch.cuda.synchronize()
            case = f"bn_act {list(shape)} {variant}"
            differ = int((got != want).sum())
            check(torch.equal(got, want), f"{case}: {differ} elements differ from the plain "
                  f"version, max-abs {float((got - want).abs().max()):.3g}")
            print(f"[kernel] {case}: equal to its plain version bit for bit", flush=True)
            cases += 1
            del got, want
        del x, r
    return cases


def check_conv3x3_kernel(inp: probe.ProbeInputs) -> float:
    """B3 vs its plain version with the probe's weight and bias: the probe's
    parity batch (64 x 32 x 32), N=3 and N=1 at 32x32, an odd map (N=5 at
    7x5: the edges and a partial tile), 9x64 (two column tiles and a ragged
    band), 33x70 (three column tiles, the last ragged, and a ragged band)
    and the probe's batch of 8192, each at assert_close's bf16 defaults.
    Prints each launch's plan, held to the kernel's own shared-memory sum.
    Returns the largest max-abs error."""
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = [inp.x_parity,
             torch.randn(3, 32, 32, 64, device="cuda", generator=g).bfloat16(),
             torch.randn(1, 32, 32, 64, device="cuda", generator=g).bfloat16(),
             torch.randn(5, 7, 5, 64, device="cuda", generator=g).bfloat16(),
             torch.randn(2, 9, 64, 64, device="cuda", generator=g).bfloat16(),
             torch.randn(2, 33, 70, 64, device="cuda", generator=g).bfloat16(),
             inp.x]
    lib = conv._library()
    max_err = 0.0
    for x in cases:
        got = conv.conv3x3_bias_relu(x, inp.w, inp.b)
        want = conv.conv3x3_bias_relu_reference(x, inp.w, inp.b)
        torch.cuda.synchronize()
        plan = conv.last_plan
        case = "conv3x3 N={} {}x{}".format(*x.shape[:3])
        smem = lib.nbdt_conv3x3_smem_bytes(plan.stages)
        check(smem == plan.smem_bytes,
              f"{case}: plan says {plan.smem_bytes} bytes of shared memory, the kernel {smem}")
        check(got.dtype == torch.bfloat16 and got.shape == x.shape, f"{case}: dtype/shape")
        torch.testing.assert_close(got, want, msg=lambda m: f"{case}: {m}")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        max_err = max(max_err, err)
        print(f"[kernel] {case} [band {plan.band_rows} rows, {plan.col_tiles} "
              f"column tiles, pitch {plan.pitch}, {plan.stages} stages, {plan.smem_bytes} B "
              f"shared memory, grid {plan.grid} over {plan.tiles} tiles]: max-abs err "
              f"{err:.3g}, share of elements that differ {float((diff > 0).float().mean()):.3g}",
              flush=True)
        del got, want, diff
    print(f"[kernel] conv3x3 plan at the probe's shape: {conv.last_plan}; ptxas "
          f"{ptxas_report('conv3x3') or 'not reported (library built earlier)'}",
          flush=True)
    return max_err


def run_conv_probe_path(inp: probe.ProbeInputs) -> dict:
    """The conv probe's main path: one request (one call at the probe's
    batch) with the count set to 0 just before it, then the probe's own
    parity and timing phases (``run_probe``) on the same inputs."""
    torch.cuda.synchronize()
    reset_launches()
    y = probe.request(inp)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 1, "bn_act": 0},
          f"conv probe request launches {launches}, expected one conv3x3")
    check(y.shape == inp.x.shape and bool(torch.isfinite(y).all()),
          f"conv probe request: bad output {tuple(y.shape)}")
    zeros = float((y == 0).float().mean())
    print(f"[probe] request of {inp.x.shape[0]} images: 1 conv3x3 launch, output "
          f"{list(y.shape)} finite, share of zeros after ReLU {zeros:.4f}", flush=True)
    del y
    # cuDNN's library row runs in bf16, where allow_tf32 (off here) plays no part.
    res = probe.run_probe(inp.x.shape[0], inp.x_parity.shape[0], TIMED, "cuda", inputs=inp)
    check(res["request"]["launches"] == 1 and res["request"]["finite"],
          f"conv probe run_probe request: {res['request']}")
    t = res["timing"]
    print(f"[times] conv3x3 N={inp.x.shape[0]} 32x32 64->64: kernel {t['kernel']['ms']:.5f} ms "
          f"({t['kernel']['tflops']:.1f} TFLOP/s), plain {t['plain']['ms']:.5f} ms, F.conv2d "
          f"+ relu_ {t['library']['ms']:.5f} ms, bound {res['bound_ms']:.5f} ms "
          f"({res['bound_by']})", flush=True)
    w_lib, b_lib = probe.library_weights(inp)
    print_profile("conv3x3 kernel request", *profile_ms(lambda: probe.request(inp), n=5))
    print_profile("F.conv2d + relu_ at the request's shape",
                  *profile_ms(lambda: probe.library_conv(inp.x, w_lib, b_lib), n=5))
    return {"launches": launches, "zero_share": zeros, **res}


def seeded_resnet18(cgen: torch.Generator) -> torch.nn.Module:
    """The ResNet18 (CIFAR10) of the main path, on the card: seeded
    BatchNorms, the classifier calibrated on 1024 images drawn from
    ``cgen``."""
    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    model = ResNet18(10)
    randomize_batchnorm(model, gen)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    calibrate_classifier(model, model.linear,
                         torch.randn(1024, 32, 32, 3, device="cuda", generator=cgen), gen)
    return model


def run_resnet_path(trees: dict) -> dict:
    """ResNet18 main path (3 requests of 8192 through SoftNBDT(fused=True):
    B1 and 17 bn_act passes each) against the plain rules over the library's
    BatchNorm, add and ReLU, and its serving fn. Returns the launches and
    the request times."""
    tree = trees["CIFAR10"]
    cgen = torch.Generator(device="cuda").manual_seed(1)
    model = seeded_resnet18(cgen)
    fused = SoftNBDT("CIFAR10", model, tree=tree, fused=True)
    plain = OnLibraryPasses(SoftNBDT("CIFAR10", model, tree=tree))
    requests = [torch.randn(BATCH, 32, 32, 3, device="cuda", generator=cgen)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    reset_launches()
    outs = [fused(x) for x in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"soft_head": REQUESTS, "layernorm": 0, "conv3x3": 0,
                       "bn_act": BN_ACT_PER_REQUEST * REQUESTS},
          f"ResNet18 path launches {launches} over {REQUESTS} requests")
    reset_launches()
    for i, (x, out) in enumerate(zip(requests, outs)):
        ref = plain(x)
        check(read_launches()["bn_act"] == 0, f"request {i}: the plain side ran bn_act")
        check(out.shape == (BATCH, 10) and bool(torch.isfinite(out).all()),
              f"request {i}: bad output {tuple(out.shape)}")
        sums = out.sum(1)
        check(bool(((sums - 1).abs() < 1e-4).all()), f"request {i}: leaf probs do not sum to 1")
        agree, ties, raw = argmax_agreement(out.log(), ref.log(), TOL)
        check(agree == 1.0, f"request {i}: fused vs plain argmax agreement {agree}")
        classes = int(out.argmax(1).unique().numel())
        print(f"[main] request {i}: fused vs plain argmax {agree} ({ties} tie rows, "
              f"raw {raw}), max |prob diff| {float((out - ref).abs().max()):.3g}, "
              f"{classes} classes predicted", flush=True)
    print(f"[main] launches over {REQUESTS} requests: {json.dumps(launches)}; soft_head "
          f"{st.last_launch['plan']}, grid {st.last_launch['grid']}", flush=True)
    _, decisions = plain.forward_with_decisions(requests[0][:4])
    path = " -> ".join(f"{s['name']} ({s['prob']:.3f})" for s in decisions[0])
    print(f"[main] decision path of image 0: {path}", flush=True)

    # Serving fn: bf16 backbone, folded BN, uint8 input (reported, not gated)
    serve = make_serving_fn(model, tree, bf16=True, fold_bn=True, uint8_input=True)
    u8 = torch.randint(0, 256, (BATCH, 32, 32, 3), dtype=torch.uint8, device="cuda",
                       generator=cgen)
    mean = torch.as_tensor(CIFAR_MEAN, device="cuda")
    std = torch.as_tensor(CIFAR_STD, device="cuda")
    served = serve(u8)
    ref = plain((u8.float() / 255.0 - mean) / std)
    check(served.shape == (BATCH, 10) and bool(torch.isfinite(served).all()),
          "serving fn: bad output")
    serve_agree = float((served.argmax(1) == ref.argmax(1)).float().mean())
    print(f"[serving] bf16+fold_bn+uint8 vs f32 plain argmax agreement {serve_agree}",
          flush=True)

    x = requests[0]
    print_profile("ResNet18 fused f32 request", *profile_ms(lambda: fused(x), n=5))
    return {
        "launches": launches,
        "fused_ms_per_request": time_cuda(lambda: fused(x), n=10),
        "plain_ms_per_request": time_cuda(lambda: plain(x), n=10),
        "serving_bf16_folded_uint8_ms_per_request": time_cuda(lambda: serve(u8), n=10),
    }


def run_vit_path(tree: Tree) -> dict:
    """ViT-B/16 main path: 3 requests of 256 images at 224px through
    SoftNBDT(fused=True) with a bf16 stream and ln_impl="pallas", then the
    f32 gate and the serving fn. Returns the launches and the request
    times."""
    torch.manual_seed(10)
    gen = torch.Generator().manual_seed(11)
    cgen = torch.Generator(device="cuda").manual_seed(12)
    base = vit_b16(VIT_CLASSES, ln_impl="pallas").to("cuda").eval()  # f32 stream
    calibrate_classifier(base, base.heads.head, torch.randn(
        VIT_BATCH, VIT_IMG, VIT_IMG, 3, device="cuda", generator=cgen), gen)
    bf16 = variant(base, dtype=torch.bfloat16)
    fused = SoftNBDT("Imagenet1000", bf16, tree=tree, fused=True)
    requests = [torch.randn(VIT_BATCH, VIT_IMG, VIT_IMG, 3, device="cuda", generator=cgen)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    reset_launches()
    outs = [fused(x) for x in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    want = {"soft_head": REQUESTS, "layernorm": VIT_LN_PER_REQUEST * REQUESTS, "conv3x3": 0,
            "bn_act": 0}
    check(launches == want, f"ViT path launches {launches} over {REQUESTS} requests, "
                            f"expected {want}")
    for i, out in enumerate(outs):
        check(out.shape == (VIT_BATCH, VIT_CLASSES) and bool(torch.isfinite(out).all()),
              f"ViT request {i}: bad output {tuple(out.shape)}")
        dev = float((out.sum(1) - 1).abs().max())
        check(dev < 1e-4, f"ViT request {i}: leaf probs sum to 1 only within {dev:.3g}")
        classes = int(out.argmax(1).unique().numel())
        print(f"[vit] request {i}: {classes} of {VIT_CLASSES} classes predicted, "
              f"max |sum - 1| {dev:.3g}", flush=True)
    print(f"[vit] launches over {REQUESTS} requests: {json.dumps(launches)}; soft_head "
          f"{st.last_launch['plan']}, grid {st.last_launch['grid']}", flush=True)
    # B1 vs its plain version on the features this path hands it
    with torch.no_grad():
        feats = fused.model(requests[0].permute(0, 3, 1, 2), features_only=True)
    check(feats.shape == (VIT_BATCH, VIT_DIM) and feats.dtype == torch.float32,
          f"ViT features {tuple(feats.shape)} {feats.dtype}")
    gate_soft_head(feats, fused._head, True,
                   f"soft_head on ViT request 0 features B={VIT_BATCH} D={VIT_DIM}", "[vit]")
    plain = SoftNBDT("Imagenet1000", variant(base, dtype=torch.bfloat16, ln_impl="f32"),
                     tree=tree)
    _, decisions = plain.forward_with_decisions(requests[0][:2])
    path = " -> ".join(f"{s['name']} ({s['prob']:.3f})" for s in decisions[0])
    print(f"[vit] decision path of image 0 ({len(decisions[0])} steps): {path}", flush=True)

    # f32 gate: the same weights in an f32 stream (TF32 off), kernels vs plain
    x = requests[0]
    f32_plain_nbdt = SoftNBDT("Imagenet1000", variant(base, ln_impl="f32"), tree=tree)
    f32_fused = SoftNBDT("Imagenet1000", base, tree=tree, fused=True)(x)
    f32_plain = f32_plain_nbdt(x)
    agree, ties, raw = argmax_agreement(f32_fused.log(), f32_plain.log(), TOL)
    print(f"[vit] f32 gate: pallas+fused vs f32-LN+plain argmax {agree} on decided rows "
          f"({ties} tie rows within {TOL}, raw {raw}), max |leaf log-prob diff| "
          f"{float((f32_fused.log() - f32_plain.log()).abs().max()):.3g}", flush=True)
    check(agree == 1.0, f"ViT f32 gate: argmax agreement {agree}")
    bf_agree = float((outs[0].argmax(1) == f32_plain.argmax(1)).float().mean())
    print(f"[vit] bf16 pallas+fused vs f32-LN+plain f32 argmax agreement {bf_agree} "
          "(reported, not gated: bf16 rounding on random weights)", flush=True)

    # Serving fn: bf16, uint8 input, ImageNet normalize (reported, not gated)
    serve = make_serving_fn(base, tree, bf16=True, uint8_input=True,
                            normalize=(IMAGENET_MEAN, IMAGENET_STD))
    u8 = torch.randint(0, 256, (VIT_BATCH, VIT_IMG, VIT_IMG, 3), dtype=torch.uint8,
                       device="cuda", generator=cgen)
    mean = torch.as_tensor(IMAGENET_MEAN, device="cuda")
    std = torch.as_tensor(IMAGENET_STD, device="cuda")
    ln.launches = 0
    served = serve(u8)
    torch.cuda.synchronize()
    serve_ln = ln.launches
    check(served.shape == (VIT_BATCH, VIT_CLASSES) and bool(torch.isfinite(served).all()),
          "ViT serving fn: bad output")
    check(serve_ln == VIT_LN_PER_REQUEST,
          f"ViT serving fn: {serve_ln} layernorm launches, expected {VIT_LN_PER_REQUEST}")
    ref = f32_plain_nbdt((u8.float() / 255.0 - mean) / std)
    print(f"[vit serving] bf16+uint8+ImageNet normalize vs f32 plain argmax agreement "
          f"{float((served.argmax(1) == ref.argmax(1)).float().mean())}, "
          f"layernorm launches {serve_ln}", flush=True)
    del f32_plain_nbdt, f32_fused, f32_plain, ref, served

    print_profile("ViT-B/16 bf16 pallas+fused request", *profile_ms(lambda: fused(x), n=5))
    fused_ms = time_cuda(lambda: fused(x))
    plain_ms = time_cuda(lambda: plain(x))
    return {
        "launches": launches,
        "fused_ms_per_request": fused_ms,
        "fused_wall_ms_per_request": wall_ms(lambda: fused(x)),
        "plain_f32ln_ms_per_request": plain_ms,
        "plain_f32ln_wall_ms_per_request": wall_ms(lambda: plain(x)),
        "serving_bf16_uint8_ms_per_request": time_cuda(lambda: serve(u8)),
    }


class PrecisionSpy(torch.utils._python_dispatch.TorchDispatchMode):
    """Records (operand shapes, float32 matmul precision) of every matrix
    product dispatched while it is active, forward and backward."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            self.calls.append((shapes, torch.get_float32_matmul_precision()))
        return func(*args, **(kwargs or {}))


def check_tree_matmul_precision(model, x: torch.Tensor, y: torch.Tensor, jt) -> int:
    """Under a process-wide "medium" f32 precision (TF32 for the backbone),
    a forward and backward of the soft and hard tree losses on the card:
    every product that touches the tree's N*K slots runs at "highest", in
    both passes (two products a loss forward, two backward). Returns their
    count."""
    S = jt.num_inodes * jt.max_children
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        spy = PrecisionSpy()
        with spy:
            logits = model(x.permute(0, 3, 1, 2))
            (tl.soft_tree_sup_loss(logits, y, jt) + tl.hard_tree_sup_loss(logits, y, jt)).backward()
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(prev)
        model.zero_grad(set_to_none=True)
    tree = [prec for shapes, prec in spy.calls if any(S in shape for shape in shapes)]
    check(len(tree) == 6 and set(tree) == {"highest"},
          f"tree-loss products and their precisions: {tree}")
    return len(tree)


def train_run(label: str, cfg: TrainConfig, model, trainloader, testloader, tree,
              criterion_state=None, analyzer=None) -> tuple:
    """Trains TRAIN_EPOCHS epochs through a Trainer on the card; gates that
    every step's loss is finite and that the epoch-1 mean loss is below the
    epoch-0 mean. Returns (trainer, report): per epoch the device ms a step
    (CUDA events around the epoch), the host-clock ms a step (the epoch ends
    in a sync) and images/s; the test accuracy."""
    tr = Trainer(cfg, model, trainloader, testloader, tree=tree, analyzer=analyzer)
    if criterion_state is not None:
        tr.criterion_state = criterion_state(tr)
    epochs = []
    for epoch in range(TRAIN_EPOCHS):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        stats = tr.train_epoch(epoch)
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        losses = stats["step_losses"]
        check(len(losses) > 0 and all(math.isfinite(v) for v in losses),
              f"{label} epoch {epoch}: step losses {losses}")
        steps = len(losses)
        device_ms = start.elapsed_time(end) / steps
        epochs.append({"steps": steps, "mean_loss": float(np.mean(losses)),
                       "device_ms_per_step": device_ms, "host_ms_per_step": wall / steps,
                       "images_per_s": cfg.batch_size / device_ms * 1e3})
    check(epochs[1]["mean_loss"] < epochs[0]["mean_loss"],
          f"{label}: epoch-1 mean loss {epochs[1]['mean_loss']} is not below epoch 0's "
          f"{epochs[0]['mean_loss']}")
    acc = tr.evaluate(TRAIN_EPOCHS - 1, checkpoint=False)
    print(f"[train] {label}: " + "; ".join(
        f"epoch {i}: {e['steps']} steps, mean loss {e['mean_loss']:.4f}, "
        f"{e['device_ms_per_step']:.3f} device ms/step, {e['host_ms_per_step']:.3f} host ms/step, "
        f"{e['images_per_s']:.1f} images/s" for i, e in enumerate(epochs))
        + f"; test accuracy {acc:.2f}%", flush=True)
    return tr, {"epochs": epochs, "test_acc": acc}


def card_vs_cpu_step(tag: str, make_model, head: str, init, cfg: TrainConfig, trainset,
                     tree, batch: int, lr_at) -> dict:
    """One SoftTreeSupLoss step on the card and the same step on the CPU,
    from ``init``'s weights and the first ``batch`` training images: the
    losses within XSTEP_RTOL relative (the same f32 step, TF32 off, sums in
    other orders). Returns the losses and the classifier ``head``'s largest
    weight difference after the step."""
    x = torch.as_tensor(trainset.images[:batch])
    y = torch.as_tensor(trainset.labels[:batch])
    out = {}
    for dev in ("cuda", "cpu"):
        model = make_model()
        model.load_state_dict(init.state_dict())
        model = model.to(dev, memory_format=torch.channels_last)
        step = make_train_step(model, make_optimizer(cfg, model.parameters()), lr_at,
                               "SoftTreeSupLoss", to_device_tree(tree.arrays, dev),
                               normalize=(trainset.mean, trainset.std))
        m = step(x.to(dev), y.to(dev), 1.0, 1.0, 0)
        out[dev] = (float(m["loss"]), model.get_submodule(head).weight.detach().cpu())
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    wdiff = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    check(rel <= XSTEP_RTOL, f"{tag} card vs CPU step: loss {out['cuda'][0]} vs "
                             f"{out['cpu'][0]}")
    print(f"{tag} one step at batch {batch}, card vs CPU: loss {out['cuda'][0]:.7f} vs "
          f"{out['cpu'][0]:.7f} (relative {rel:.3g}, tolerance {XSTEP_RTOL}), classifier "
          f"weight max |diff| after the step {wdiff:.3g}", flush=True)
    return {"batch": batch, "loss_cuda": out["cuda"][0], "loss_cpu": out["cpu"][0],
            "relative": rel, "classifier_max_abs_diff": wdiff}


def run_training_path(workdir: Path) -> dict:
    """Tree-supervised ResNet18 training (10 classes, 32px, batch 512, the
    CIFAR10 induced tree) on learnable synthetic data, f32 with TF32 off:
    1. SoftTreeSupLoss in cached mode, 2. HardTreeSupLoss host-fed through
    PrefetchLoader, 3. SoftTreeLoss whose tree is regenerated from the live
    weights at epoch 1, 4. the CLI with no hierarchy (induced from the fresh
    model), 5. save and resume, 6. one step on the card against the same
    step on the CPU; and the tree-loss products' precision. Every kernel's
    launch count stays 0: training runs the plain rules."""
    shutil.rmtree(workdir, ignore_errors=True)
    trainset = LearnableSyntheticDataset(10, size=TRAIN_SIZE, seed=0)
    testset = LearnableSyntheticDataset(10, size=TEST_SIZE, seed=0, train=False)
    testloader = DataLoader(testset, TRAIN_BATCH, transform=testset.transform_val(),
                            drop_last=False, pad_last=True)
    cfg = dict(dataset="CIFAR10", arch="ResNet18", batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
               checkpoint_dir=str(workdir))
    torch.manual_seed(20)
    init = ResNet18(10)
    torch.cuda.synchronize()
    reset_launches()

    # 1. SoftTreeSupLoss, cached mode
    cached_cfg = TrainConfig(loss="SoftTreeSupLoss", cache_dataset=True, **cfg)
    cached_loader = DataLoader(trainset, TRAIN_BATCH, shuffle=True,
                               transform=trainset.transform_train())
    tr1, soft = train_run("SoftTreeSupLoss cached", cached_cfg, init, cached_loader, testloader,
                          Tree("CIFAR10"))
    # 2. HardTreeSupLoss, host-fed through PrefetchLoader (the short last batch trains),
    # its batches gathered and augmented by the native host kernels
    host_loader = PrefetchLoader(DataLoader(trainset, TRAIN_BATCH, shuffle=True,
                                            transform=trainset.transform_train(),
                                            drop_last=False))
    before = dict(native.calls)
    tr2, hard = train_run("HardTreeSupLoss host-fed", TrainConfig(loss="HardTreeSupLoss", **cfg),
                          init, host_loader, testloader, Tree("CIFAR10"))
    hard["native_calls"] = {k: native.calls[k] - before[k] for k in before}
    xb = torch.as_tensor(trainset.images[:TRAIN_BATCH], device="cuda")
    yb = torch.as_tensor(trainset.labels[:TRAIN_BATCH], device="cuda")
    xn = ((xb.float() / 255.0 - torch.as_tensor(CIFAR_MEAN, device="cuda"))
          / torch.as_tensor(CIFAR_STD, device="cuda"))  # a host-fed batch, on the card
    print_profile("ResNet18 train step, batch 512, f32, HardTreeSupLoss",
                  *profile_ms(lambda: tr2.train_step(xn, yb, 1.0, 1.0, tr2.step_count), n=5))
    # 3. SoftTreeLoss: CE first, then the tree regenerated from the card's live weights
    stl_tree = Tree("CIFAR10")

    def soft_tree_loss(tr):
        return tl.SoftTreeLoss(tree=stl_tree, arch="ResNet18", checkpoint_path=str(workdir),
                               model_fn=lambda: tr.model, tree_start_epochs=1,
                               tree_update_every_epochs=1, tree_update_end_epochs=2)

    stl_cfg = TrainConfig(loss="SoftTreeLoss", cache_dataset=True, tree_start_epochs=1,
                          tree_update_every_epochs=1, tree_update_end_epochs=2, **cfg)
    tr3, stl = train_run("SoftTreeLoss cached, refresh at epoch 1", stl_cfg, init,
                         cached_loader, testloader, Tree("CIFAR10"), soft_tree_loss)
    check((workdir / "graph-epoch1.json").exists() and tr3.jt is tr3.criterion_state.jt,
          "SoftTreeLoss: no refresh at epoch 1")
    stl["induced_nodes"] = len(stl_tree.G)
    print(f"[train] SoftTreeLoss refreshed its tree at epoch 1 from the live weights: "
          f"{stl['induced_nodes']} nodes", flush=True)

    # 4. The CLI, no --hierarchy: the tree is induced from the fresh model
    t0 = time.perf_counter()
    cli_acc = train_cli(["--synthetic", "--dataset", "CIFAR10", "--arch", "ResNet18", "--loss",
                         "SoftTreeSupLoss", "--epochs", "1", "--no-progress",
                         "--checkpoint-dir", str(workdir / "cli")])
    graph = workdir / "cli" / "CIFAR10" / "graph-induced-ResNet18.json"
    check(graph.exists(), f"CLI: no induced tree at {graph}")
    cli = {"test_acc": cli_acc, "seconds": time.perf_counter() - t0,
           "induced_nodes": len(Tree("CIFAR10", path_graph=str(graph)).G)}
    print(f"[train] python -m nbdt_torch.main --synthetic ... --epochs 1: test accuracy "
          f"{cli_acc:.2f}%, induced tree of {cli['induced_nodes']} nodes, "
          f"{cli['seconds']:.1f} s", flush=True)

    # 5. Save, then resume into a fresh trainer
    path = tr1.save(TRAIN_EPOCHS, soft["test_acc"])
    tr5 = Trainer(cached_cfg, ResNet18(10), cached_loader, testloader, tree=Tree("CIFAR10"))
    tr5.load(path)
    resumed_acc = tr5.evaluate(TRAIN_EPOCHS, checkpoint=False)
    check(resumed_acc == soft["test_acc"] and not tr5.optimizer.state,
          f"resume: accuracy {resumed_acc} vs {soft['test_acc']}, momentum kept")
    seen = []
    tr5.optimizer.register_step_pre_hook(lambda opt, a, k: seen.append(opt.param_groups[0]["lr"]))
    tr5.train_epoch(TRAIN_EPOCHS)
    lr_at = lr_schedule(cached_cfg, TRAIN_SIZE // TRAIN_BATCH)
    first = TRAIN_EPOCHS * (TRAIN_SIZE // TRAIN_BATCH)
    check(seen == [lr_at(first + i) for i in range(len(seen))] and len(seen) > 0,
          f"resume: learning rates {seen[:3]}... off the schedule from step {first}")
    resume = {"test_acc": resumed_acc, "first_step": first, "lr": seen[0]}
    print(f"[train] resumed at step {first} (lr {seen[0]:.3g}, the schedule's): test accuracy "
          f"{resumed_acc:.2f}%, equal to the saved trainer's", flush=True)

    # 6. One step on the card and the same step on the CPU, from one init and batch
    xstep = card_vs_cpu_step("[train]", lambda: ResNet18(10), "linear", init, cached_cfg,
                             trainset, tr1.tree, XSTEP_BATCH, lr_at)

    n_products = check_tree_matmul_precision(tr1.model, xn, yb, tr1.jt)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"training path launched kernels: {launches}")
    print(f"[train] tree-loss products at \"highest\" under \"medium\", forward and backward: "
          f"{n_products}; kernel launches over the training path: {json.dumps(launches)}",
          flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    return {"batch": TRAIN_BATCH, "image": 32, "classes": 10, "train_images": TRAIN_SIZE,
            "launches": launches, "soft_cached": soft, "hard_host_fed": hard,
            "soft_tree_loss": stl, "cli": cli, "resume": resume,
            "card_vs_cpu_step": xstep, "tree_products_highest": n_products}


def run_wrn_serving(tree: Tree) -> dict:
    """WRN-28-10 CIFAR100 serving: 3 requests of 1024 images through
    SoftNBDT(fused=True) (one B1 launch each, the cluster instance at D=640,
    C=100) against the plain rules, B1 on this path's own features, a
    HardNBDT decision path, and the bf16 serving fn with uint8 input.
    Returns the launches and the request times."""
    gen = torch.Generator().manual_seed(30)
    torch.manual_seed(30)
    model = wrn28_10_cifar100()
    randomize_batchnorm(model, gen)
    cgen = torch.Generator(device="cuda").manual_seed(31)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    calibrate_classifier(model, model.output,
                         torch.randn(WRN_BATCH, 32, 32, 3, device="cuda", generator=cgen), gen)
    fused = SoftNBDT("CIFAR100", model, tree=tree, fused=True)
    plain = SoftNBDT("CIFAR100", model, tree=tree)
    requests = [torch.randn(WRN_BATCH, 32, 32, 3, device="cuda", generator=cgen)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    reset_launches()
    outs = [fused(x) for x in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"soft_head": REQUESTS, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"WRN-28-10 path launches {launches} over {REQUESTS} requests")
    for i, (x, out) in enumerate(zip(requests, outs)):
        ref = plain(x)
        check(out.shape == (WRN_BATCH, WRN_CLASSES) and bool(torch.isfinite(out).all()),
              f"WRN request {i}: bad output {tuple(out.shape)}")
        dev = float((out.sum(1) - 1).abs().max())
        check(dev < 1e-4, f"WRN request {i}: leaf probs sum to 1 only within {dev:.3g}")
        agree, ties, raw = argmax_agreement(out.log(), ref.log(), TOL)
        check(agree == 1.0, f"WRN request {i}: fused vs plain argmax agreement {agree}")
        classes = int(out.argmax(1).unique().numel())
        print(f"[wrn] request {i}: fused vs plain argmax {agree} ({ties} tie rows, raw {raw}), "
              f"max |prob diff| {float((out - ref).abs().max()):.3g}, max |sum - 1| {dev:.3g}, "
              f"{classes} of {WRN_CLASSES} classes predicted", flush=True)
    print(f"[wrn] launches over {REQUESTS} requests: {json.dumps(launches)}; soft_head "
          f"{st.last_launch['plan']}, grid {st.last_launch['grid']}", flush=True)
    with torch.no_grad():
        feats = fused.model(requests[0].permute(0, 3, 1, 2), features_only=True)
    check(feats.shape == (WRN_BATCH, WRN_DIM) and feats.dtype == torch.float32,
          f"WRN features {tuple(feats.shape)} {feats.dtype}")
    gate_soft_head(feats, fused._head, True,
                   f"soft_head on WRN request 0 features B={WRN_BATCH} D={WRN_DIM}", "[wrn]",
                   exact=True)
    _, decisions = HardNBDT("CIFAR100", model, tree=tree).forward_with_decisions(
        requests[0][:4])
    path = " -> ".join(f"{s['name']} ({s['prob']:.3f})" for s in decisions[0])
    print(f"[wrn] HardNBDT decision path of image 0 ({len(decisions[0])} steps): {path}",
          flush=True)

    # Serving fn: bf16 backbone, uint8 input, CIFAR100's normalize
    serve = make_serving_fn(model, tree, bf16=True, uint8_input=True,
                            normalize=(CIFAR_MEAN, CIFAR_STD))
    u8 = torch.randint(0, 256, (WRN_BATCH, 32, 32, 3), dtype=torch.uint8, device="cuda",
                       generator=cgen)
    mean = torch.as_tensor(CIFAR_MEAN, device="cuda")
    std = torch.as_tensor(CIFAR_STD, device="cuda")
    served = serve(u8)
    ref = plain((u8.float() / 255.0 - mean) / std)
    check(served.shape == (WRN_BATCH, WRN_CLASSES) and bool(torch.isfinite(served).all()),
          "WRN serving fn: bad output")
    serve_agree = float((served.argmax(1) == ref.argmax(1)).float().mean())
    print(f"[wrn serving] bf16+uint8 vs f32 plain argmax agreement {serve_agree} "
          f"(floor {WRN_BF16_AGREE})", flush=True)
    check(serve_agree >= WRN_BF16_AGREE, f"WRN serving fn: argmax agreement {serve_agree}")

    x = requests[0]
    print_profile(f"WRN-28-10 fused f32 request of {WRN_BATCH}",
                  *profile_ms(lambda: fused(x), n=3))
    return {
        "launches": launches,
        "serving_bf16_uint8_argmax_agreement": serve_agree,
        "fused_ms_per_request": time_cuda(lambda: fused(x), n=WRN_TIMED),
        "fused_wall_ms_per_request": wall_ms(lambda: fused(x), n=WRN_TIMED),
        "plain_ms_per_request": time_cuda(lambda: plain(x), n=WRN_TIMED),
        "serving_bf16_uint8_ms_per_request": time_cuda(lambda: serve(u8), n=WRN_TIMED),
    }


def run_cli(argv: list) -> tuple:
    """``python -m nbdt_torch.main`` in this process: (its return value, its
    standard output, which is also echoed)."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            ret = train_cli(argv)
    finally:
        sys.stdout.write(buf.getvalue())
        sys.stdout.flush()
    return ret, buf.getvalue()


def nbdt_line(text: str, name: str) -> tuple:
    """(accuracy, correct, total) of the last ``[name] Accuracy`` line."""
    found = re.findall(rf"\[{name}\] Accuracy: ([\d.]+)%, (\d+)/(\d+)", text)
    check(bool(found), f"no [{name}] accuracy line in the output")
    acc, correct, total = found[-1]
    return float(acc), int(correct), int(total)


def run_wrn_training(tree: Tree, workdir: Path) -> dict:
    """Tree-supervised WRN-28-10 training (CIFAR100, 32px, batch 512, the
    induced-wrn28_10_cifar100 tree) on learnable synthetic data, f32 with
    TF32 off: SoftTreeSupLoss cached with the SoftEmbeddedDecisionRules
    analyzer, HardTreeSupLoss host-fed with HardEmbeddedDecisionRules; then
    the host-fed trainer evaluated under each analyzer (device-counted
    through ``device_eval``) and each NBDT accuracy recomputed from the eval
    logits with the plain rules; a card-vs-CPU step; the tree-loss products'
    precision; then the CLI on 64px TinyImagenet200 (train, then ``--eval
    --checkpoint-path`` of the .pth it wrote). No kernel launches."""
    shutil.rmtree(workdir, ignore_errors=True)
    trainset = LearnableSyntheticDataset(WRN_CLASSES, size=WRN_TRAIN_SIZE, seed=0)
    testset = LearnableSyntheticDataset(WRN_CLASSES, size=WRN_TEST_SIZE, seed=0, train=False)
    testloader = DataLoader(testset, TRAIN_BATCH, transform=testset.transform_val(),
                            drop_last=False, pad_last=True)
    cfg = dict(dataset="CIFAR100", arch="wrn28_10_cifar100", batch_size=TRAIN_BATCH,
               epochs=TRAIN_EPOCHS, checkpoint_dir=str(workdir))
    torch.manual_seed(40)
    init = wrn28_10_cifar100()
    torch.cuda.synchronize()
    reset_launches()

    cached_cfg = TrainConfig(loss="SoftTreeSupLoss", cache_dataset=True, **cfg)
    cached_loader = DataLoader(trainset, TRAIN_BATCH, shuffle=True,
                               transform=trainset.transform_train())
    tr1, soft = train_run("WRN-28-10 SoftTreeSupLoss cached", cached_cfg, init, cached_loader,
                          testloader, tree, analyzer=SoftAnalyzer(tree=tree))
    host_loader = PrefetchLoader(DataLoader(trainset, TRAIN_BATCH, shuffle=True,
                                            transform=trainset.transform_train()))
    tr2, hard = train_run("WRN-28-10 HardTreeSupLoss host-fed",
                          TrainConfig(loss="HardTreeSupLoss", **cfg), init, host_loader,
                          testloader, tree, analyzer=HardAnalyzer(tree=tree))

    # The NBDT accuracies, device-counted, against the plain rules on the eval logits
    logits, labels = [], []
    for x, y, v in testloader:
        logits.append(tr2.eval_step(torch.as_tensor(x, device="cuda"))[torch.as_tensor(v)])
        labels.append(torch.as_tensor(y)[torch.as_tensor(v)])
    logits, labels = torch.cat(logits), torch.cat(labels).cuda()
    nbdt = {}
    for analyzer in (SoftAnalyzer(tree=tree), HardAnalyzer(tree=tree)):
        check(analyzer.device_eval() is not None, f"{analyzer.name}: no device_eval")
        tr2.analyzer = analyzer
        backbone = tr2.evaluate(TRAIN_EPOCHS, checkpoint=False)
        hits = int((analyzer.rules.forward(logits).argmax(1) == labels).sum())
        got = (analyzer.metric.correct, analyzer.metric.total)
        check(got == (hits, len(labels)),
              f"{analyzer.name}: device-counted {got}, plain rules on the eval logits "
              f"{(hits, len(labels))}")
        nbdt[analyzer.name] = {"backbone_acc": backbone, "nbdt_acc": analyzer.accuracy,
                               "correct": hits, "total": len(labels)}
        print(f"[wrn train] evaluate with {type(analyzer).__name__}: backbone {backbone:.2f}%, "
              f"{analyzer.name} {analyzer.accuracy}% ({hits}/{len(labels)}, equal to the plain "
              f"rules on the eval logits)", flush=True)

    xb = torch.as_tensor(trainset.images[:TRAIN_BATCH], device="cuda")
    yb = torch.as_tensor(trainset.labels[:TRAIN_BATCH], device="cuda")
    xn = ((xb.float() / 255.0 - torch.as_tensor(CIFAR_MEAN, device="cuda"))
          / torch.as_tensor(CIFAR_STD, device="cuda"))
    print_profile("WRN-28-10 train step, batch 512, f32, HardTreeSupLoss",
                  *profile_ms(lambda: tr2.train_step(xn, yb, 1.0, 1.0, tr2.step_count), n=3))

    xstep = card_vs_cpu_step("[wrn train]", wrn28_10_cifar100, "output", init, cached_cfg,
                             trainset, tree, WRN_XSTEP_BATCH,
                             lr_schedule(cached_cfg, WRN_TRAIN_SIZE // TRAIN_BATCH))
    n_products = check_tree_matmul_precision(tr1.model, xn[:64], yb[:64], tr1.jt)
    del tr1, tr2, logits, xb, xn

    # The CLI on 64px TinyImagenet200: train, then evaluate the .pth it wrote
    cli_dir = workdir / "cli"
    t0 = time.perf_counter()
    base = ["--synthetic", "--dataset", "TinyImagenet200", "--arch", "wrn28_10",
            "--hierarchy", "induced-wrn28_10", "--batch-size", str(WRN_CLI_BATCH), "--no-progress",
            "--checkpoint-dir", str(cli_dir)]
    cli_acc, text = run_cli(base + ["--loss", "HardTreeSupLoss", "--analysis",
                                    "HardEmbeddedDecisionRules", "--epochs", str(TRAIN_EPOCHS)])
    cli_hard = nbdt_line(text, "NBDT-Hard")
    train_s = time.perf_counter() - t0
    pth = cli_dir / "ckpt-TinyImagenet200-wrn28_10-induced-wrn28_10-HardTreeSupLoss-last.pth"
    check(pth.exists(), f"CLI: no checkpoint at {pth}")
    eval_acc, text = run_cli(base + ["--eval", "--checkpoint-path", str(pth),
                                     "--analysis", "SoftEmbeddedDecisionRules"])
    check("Loaded pretrained weights" in text, "CLI --eval: the checkpoint was not loaded")
    shutil.copy(pth, WRN_CLI_PTH)  # R3 of the release path
    cli_soft = nbdt_line(text, "NBDT-Soft")
    check(math.isfinite(eval_acc) and cli_soft[2] == 2 * WRN_CLI_BATCH,
          f"CLI --eval: accuracy {eval_acc}, NBDT-Soft {cli_soft}")
    cli = {"batch": WRN_CLI_BATCH, "image": 64, "classes": 200,
           "steps": TRAIN_EPOCHS * 4, "train_seconds": train_s, "test_acc": cli_acc,
           "nbdt_hard_acc": cli_hard[0], "eval_acc": eval_acc, "eval_nbdt_soft_acc": cli_soft[0],
           "seconds": time.perf_counter() - t0}
    print(f"[wrn train] CLI TinyImagenet200 wrn28_10 at 64px: {cli['steps']} steps, "
          f"NBDT-Hard {cli_hard[0]}%, then --eval --checkpoint-path: backbone {eval_acc:.2f}%, "
          f"NBDT-Soft {cli_soft[0]}%, {cli['seconds']:.1f} s", flush=True)

    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"WRN training and eval path launched kernels: {launches}")
    print(f"[wrn train] tree-loss products at \"highest\": {n_products}; kernel launches over "
          f"the WRN training and eval path: {json.dumps(launches)}", flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    return {"batch": TRAIN_BATCH, "image": 32, "classes": WRN_CLASSES,
            "train_images": WRN_TRAIN_SIZE, "launches": launches, "soft_cached": soft,
            "hard_host_fed": hard, "nbdt": nbdt, "cli_tinyimagenet200": cli,
            "card_vs_cpu_step": xstep, "tree_products_highest": n_products}


@contextlib.contextmanager
def timed_epochs(records: list):
    """Records, for every ``Trainer.train_epoch`` run inside (the CLI's too),
    its steps, mean loss and device ms a step by CUDA events around it."""
    real = Trainer.train_epoch

    def timed(self, epoch):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        stats = real(self, epoch)
        end.record()
        torch.cuda.synchronize()
        losses = stats["step_losses"]
        check(len(losses) > 0 and all(math.isfinite(v) for v in losses),
              f"epoch {epoch}: step losses {losses}")
        ms = start.elapsed_time(end) / len(losses)
        records.append({"steps": len(losses), "mean_loss": float(np.mean(losses)),
                        "step_losses": [float(v) for v in losses],
                        "device_ms_per_step": ms,
                        "images_per_s": self.config.batch_size / ms * 1e3})
        return stats

    Trainer.train_epoch = timed
    try:
        yield records
    finally:
        Trainer.train_epoch = real


def run_zero_shot_path(workdir: Path) -> dict:
    """The zero-shot flow with ViT-B/16 (dim 768, depth 12, 12 heads) in f32
    with TF32 off and ``ln_impl="f32"``, as the JAX CLI builds it:
    Z1. ``python -m nbdt_torch.main`` trains on CIFAR10 at 32px without cat
        and dog (SoftTreeSupLoss on the vendored WordNet tree, the
        mini-corpus merged from the vendored CIFAR10 and CIFAR100 WordNet
        graphs), 2 epochs at batch 256;
    Z2. the CLI's zero-shot eval of its .pth on CIFAR100's classes with
        Superclass and SuperclassNBDT over 'animal' and 'vehicle', each
        count held to the analyzer's forward on logits computed here, and
        the class mismatch refused without --disable-test-eval;
    Z3. the Trainer at the published 224px on 1000 classes with 900-999
        unseen, cached, 8 steps an epoch, and a card-vs-CPU step;
    Z4. no kernel launch over Z1-Z3."""
    from nbdt_torch.analysis import Superclass, SuperclassNBDT
    from nbdt_torch.data import ArrayDataset, ExcludeLabelsDataset, SyntheticDataset
    from nbdt_torch.hierarchy.wnid import clear_mini_corpus, mini_corpus_from_graph_json
    from nbdt_torch.main import build_datasets, get_parser
    from nbdt_torch.model import load_checkpoint
    from nbdt_torch.models import get_model
    from nbdt_torch.trainer import make_eval_step
    from nbdt_torch.utils import hierarchy_to_path_graph

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    table = {}
    for dataset in ("CIFAR10", "CIFAR100"):
        table.update(mini_corpus_from_graph_json(hierarchy_to_path_graph(dataset, "wordnet")))
    corpus = workdir / "mini-corpus.json"
    corpus.write_text(json.dumps(table))
    torch.cuda.synchronize()
    reset_launches()

    # Z1. Train through the CLI with cat and dog unseen
    base = ["--dataset", "CIFAR10", "--arch", "vit_b16", "--synthetic", "--hierarchy", "wordnet",
            "--mini-corpus", str(corpus), "--batch-size", str(ZS_BATCH), "--no-progress",
            "--checkpoint-dir", str(workdir)]
    t0 = time.perf_counter()
    with timed_epochs([]) as epochs:
        run_cli(base + ["--exclude-labels", *ZS_EXCLUDE, "--loss", "SoftTreeSupLoss",
                        "--epochs", str(TRAIN_EPOCHS), "--lr", ZS_LR])
    z1_s = time.perf_counter() - t0
    check(len(epochs) == TRAIN_EPOCHS, f"Z1: {len(epochs)} epochs ran")
    check(epochs[1]["mean_loss"] < epochs[0]["mean_loss"],
          f"Z1: epoch-1 mean loss {epochs[1]['mean_loss']} is not below epoch 0's "
          f"{epochs[0]['mean_loss']}")
    pth = workdir / (f"ckpt-CIFAR10-vit_b16-lr{ZS_LR}-wordnet-excl{','.join(ZS_EXCLUDE)}"
                     "-SoftTreeSupLoss-last.pth")
    check(pth.exists(), f"Z1: no checkpoint at {pth} (the name carries the excluded labels)")
    print(f"[zero-shot] Z1 CLI vit_b16 CIFAR10 32px, labels 3 and 5 excluded, SoftTreeSupLoss "
          f"on the WordNet tree, lr {ZS_LR}: " + "; ".join(
              f"epoch {i}: {e['steps']} steps, losses {[round(v, 4) for v in e['step_losses']]}, "
              f"mean {e['mean_loss']:.4f}, {e['device_ms_per_step']:.3f} device ms/step, "
              f"{e['images_per_s']:.1f} images/s" for i, e in enumerate(epochs))
          + f"; {pth.name}; {z1_s:.1f} s", flush=True)

    # Z2. Zero-shot eval on CIFAR100's classes, from Z1's .pth
    argv = base + ["--eval", "--checkpoint-path", str(pth), "--dataset-test", "CIFAR100",
                   "--superclass-wnids", *ZS_SUPERCLASSES]
    trainset, testset = build_datasets(get_parser().parse_args(argv + ["--disable-test-eval"]))
    model = get_model("vit_b16", 10, image_size=32)
    model.load_state_dict(load_checkpoint(pth), strict=True)
    step = make_eval_step(model.to("cuda", memory_format=torch.channels_last), "cuda")
    logits, labels = [], []
    for x, y, v in DataLoader(testset, ZS_BATCH, transform=testset.transform_val(),
                              drop_last=False, pad_last=True):
        logits.append(step(torch.as_tensor(x, device="cuda")).cpu().numpy()[v])
        labels.append(np.asarray(y)[v])
    logits, labels = np.concatenate(logits), np.concatenate(labels)
    tree = Tree("CIFAR10", hierarchy="wordnet", classes=list(trainset.classes))
    z2 = {}
    for cls, name in ((Superclass, "Superclass"), (SuperclassNBDT, "Superclass-NBDT")):
        t0 = time.perf_counter()
        acc, text = run_cli(argv + ["--disable-test-eval", "--analysis", cls.__name__])
        _, correct, total = nbdt_line(text, name)
        an = cls(superclass_wnids=list(ZS_SUPERCLASSES), tree=tree, dataset_test="CIFAR100")
        mapped = {"CIFAR10": int((an.mapping_pred >= 0).sum()),
                  "CIFAR100": int((an.mapping_target >= 0).sum())}
        check(mapped == ZS_MAPPED, f"Z2 {name}: mapped classes {mapped}, pinned {ZS_MAPPED}")
        want_total = int((an.mapping_target[labels] >= 0).sum())
        pred, tgt = an.forward(logits, labels)
        want_correct = int((pred == tgt).sum())
        check((correct, total) == (want_correct, want_total) and total > 0,
              f"Z2 {name}: CLI {correct}/{total}, its forward on this run's logits "
              f"{want_correct}/{want_total}")
        check(acc == round(correct / total * 100, 2),
              f"Z2 {name}: the CLI's score {acc} is not the analyzer's accuracy")
        z2[cls.__name__] = {"accuracy": acc, "correct": correct, "total": total,
                            "seconds": time.perf_counter() - t0}
        print(f"[zero-shot] Z2 --eval --dataset-test CIFAR100 --analysis {cls.__name__}: "
              f"{acc}% ({correct}/{total}: the {total} CIFAR100 test samples whose class maps "
              f"to 'animal' or 'vehicle', {mapped['CIFAR100']} of 100 classes; the prediction "
              f"space maps {mapped['CIFAR10']} of 10; equal to the analyzer's forward on this "
              f"run's logits)", flush=True)
    try:
        run_cli(argv + ["--analysis", "Superclass"])
        code = 0
    except SystemExit as e:
        code = e.code
    check(code not in (0, None), "Z2: a CIFAR100 test set without --disable-test-eval ran")
    print(f"[zero-shot] Z2 without --disable-test-eval: exits nonzero ({str(code)[:60]}...)",
          flush=True)
    clear_mini_corpus()
    del model, step

    # Z3. ViT-B/16 training at 224px, labels 900-999 unseen, cached
    base_set = SyntheticDataset(1000, size=Z3_SIZE, image_size=224, seed=50)
    z3_set = ExcludeLabelsDataset(base_set, range(900, 1000))
    check(len(z3_set) // Z3_BATCH == Z3_STEPS, f"Z3: {len(z3_set)} kept images")
    cfg = TrainConfig(dataset="Imagenet1000", arch="vit_b16", batch_size=Z3_BATCH,
                      epochs=TRAIN_EPOCHS, loss="SoftTreeSupLoss", cache_dataset=True,
                      checkpoint_dir=str(workdir / "z3"))
    loader = DataLoader(z3_set, Z3_BATCH, shuffle=True, transform=z3_set.transform_train())
    tree1000 = Tree("Imagenet1000")
    torch.manual_seed(60)
    init = get_model("vit_b16", 1000, image_size=224)
    tr = Trainer(cfg, init, loader, loader, tree=tree1000)
    with timed_epochs([]) as z3_epochs:
        for epoch in range(TRAIN_EPOCHS):
            tr.train_epoch(epoch)
    check(all(e["steps"] == Z3_STEPS for e in z3_epochs), f"Z3: steps {z3_epochs}")
    print("[zero-shot] Z3 ViT-B/16 224px 1000 classes (900-999 unseen), SoftTreeSupLoss on the "
          "Imagenet1000 induced tree, cached, batch 64: " + "; ".join(
              f"epoch {i}: {e['steps']} steps, mean loss {e['mean_loss']:.4f}, "
              f"{e['device_ms_per_step']:.3f} device ms/step, {e['images_per_s']:.1f} images/s"
              for i, e in enumerate(z3_epochs)), flush=True)
    keep = z3_set.new_to_old[:Z3_XSTEP_BATCH]
    kept = ArrayDataset(base_set.images[keep], base_set.labels[keep], base_set.classes)
    xb = torch.as_tensor(base_set.images[z3_set.new_to_old[:Z3_BATCH]], device="cuda")
    yb = torch.as_tensor(base_set.labels[z3_set.new_to_old[:Z3_BATCH]], device="cuda")
    host_step = make_train_step(tr.model, tr.optimizer, tr.lr_at, "SoftTreeSupLoss", tr.jt,
                                normalize=(base_set.mean, base_set.std))
    print_profile("ViT-B/16 train step, 224px, batch 64, f32, SoftTreeSupLoss",
                  *profile_ms(lambda: host_step(xb, yb, 1.0, 1.0, 0), n=3))
    del tr, host_step, xb, yb
    xstep = card_vs_cpu_step("[zero-shot] Z3", lambda: get_model("vit_b16", 1000, image_size=224),
                             "heads.head", init, cfg, kept, tree1000, Z3_XSTEP_BATCH,
                             lr_schedule(cfg, Z3_STEPS))

    # Z4. No kernel ran
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"zero-shot path launched kernels: {launches}")
    print(f"[zero-shot] Z4 kernel launches over Z1-Z3: {json.dumps(launches)}", flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    return {"model": "vit_b16", "launches": launches,
            "z1_cli_train": {"dataset": "CIFAR10", "image": 32, "batch": ZS_BATCH,
                             "excluded": [int(v) for v in ZS_EXCLUDE], "epochs": epochs,
                             "seconds": z1_s},
            "z2_zero_shot_eval": {"dataset_test": "CIFAR100", "mapped": ZS_MAPPED, **z2},
            "z3_train_224": {"batch": Z3_BATCH, "classes": 1000, "unseen": 100,
                             "epochs": z3_epochs, "card_vs_cpu_step": xstep}}


def calibrate_batchnorm(model: torch.nn.Module, x: torch.Tensor) -> None:
    """BatchNorm running statistics of one batch (a train-mode pass with a
    cumulative average), so that a deep random network's activations keep
    their scale through its blocks; the affine stays as it was."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for m in bns:
            m.reset_running_stats()
            m.momentum = None
        model.train()
        model(x.permute(0, 3, 1, 2))
        model.eval()
        for m in bns:
            m.momentum = 0.1


def imagenet_images(n: int, img: int, gen: torch.Generator, width: int = 0) -> torch.Tensor:
    """Seeded uint8 NHWC images, img x img (img x width if given): normal
    noise around a per-image colour (uniform in [32, 224] a channel) at a
    per-image contrast (std uniform in [8, 64]). Images that differ only in
    their noise (uniform over [0, 255]) leave pooled features that differ by
    less than bf16 resolves: in a CPU run of resnet50 at 224px the folded
    bf16 serving fn then agreed with f32 on 0.125 of rows."""
    mean = torch.rand(n, 1, 1, 3, device="cuda", generator=gen) * 192 + 32
    contrast = torch.rand(n, 1, 1, 1, device="cuda", generator=gen) * 56 + 8
    noise = torch.randn(n, img, width or img, 3, device="cuda", generator=gen)
    return (mean + contrast * noise).clamp_(0, 255).round_().to(torch.uint8)


def imagenet_normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC images -> f32 with ImageNet's mean and std, as a caller
    normalizes them on the host."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=u8.device)
    std = torch.as_tensor(IMAGENET_STD, device=u8.device)
    return (u8.float() / 255.0 - mean) / std


def he_init(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded He-normal weights (std sqrt(2 / fan-in)) and zero biases for
    every conv and linear layer: a backbone without BatchNorm keeps its
    activations' scale through ReLUs that way. Under the default init a
    random SqueezeNet-1.1 maps every image to pooled features within 6e-8 of
    each other (a CPU run at 224px: its biases swamp the shrinking signal),
    so one class wins every image."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.normal_(0.0, math.sqrt(2.0 / m.weight[0].numel()), generator=gen)
                m.bias.zero_()


def imagenet_model(ctor, img: int, seed: int, sd_floor: float = 0.0):
    """A backbone on Imagenet1000 with seeded random weights: BatchNorm
    affine drawn by ``randomize_batchnorm``, its statistics and the
    classifier calibrated on IMNET_CAL seeded images of the requests'
    distribution (a 55-block random network calibrated on other inputs
    amplifies the shift: in a CPU run of B7b at 224px, normal noise
    calibrated it and normalized uniform images then reached logits of 2e6),
    on the card in eval mode. The classifier is the one the probe finds
    (``find_classifier``), calibrated with ``sd_floor``; a backbone without
    BatchNorm gets ``he_init`` weights and only its classifier
    calibrated."""
    torch.manual_seed(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    model = ctor(IMNET_CLASSES)
    randomize_batchnorm(model, gen)
    if not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules()):
        he_init(model, gen)
    model = model.to("cuda", memory_format=torch.channels_last)
    x = imagenet_normalize(imagenet_images(
        IMNET_CAL, img, torch.Generator(device="cuda").manual_seed(seed + 2)))
    calibrate_batchnorm(model, x)
    calibrate_classifier(model, find_classifier(model)[1], x, gen, sd_floor)
    return model


def serve_imagenet(name: str, model, tree: Tree, batch: int, img: int, dim: int,
                   seed: int, tag: str = "[imagenet]", bn_act_per_request: int = 0,
                   dw_per_request: int = 0) -> dict:
    """One ImageNet backbone's main path: REQUESTS requests of ``batch``
    normalized NHWC f32 images through SoftNBDT(fused=True) (one B1 launch,
    ``bn_act_per_request`` bn_act passes and ``dw_per_request`` dw_bn_swish
    passes each, counts set to 0 just before) against the plain rules over
    the library's passes (:func:`library_passes`), B1 held to its plain
    version on the path's own features (no less exact than it against f64,
    within TOL; argmax 1.0 on rows whose top-2 gap exceeds TOL), a decision
    path, a profiler line and the request times. Returns the record (with
    the fewest classes a request predicted) and the wrappers and features
    for the serving fn and B1's timing."""
    cgen = torch.Generator(device="cuda").manual_seed(seed)
    fused = SoftNBDT("Imagenet1000", model, tree=tree, fused=True)
    plain = OnLibraryPasses(SoftNBDT("Imagenet1000", model, tree=tree))
    requests = [imagenet_normalize(imagenet_images(batch, img, cgen)) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    reset_launches()
    outs = [fused(x) for x in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"soft_head": REQUESTS, "layernorm": 0, "conv3x3": 0,
                       "bn_act": bn_act_per_request * REQUESTS},
          f"{name} path launches {launches} over {REQUESTS} requests")
    launches["dw_bn_swish"] = dw.launches
    check(dw.launches == dw_per_request * REQUESTS,
          f"{name} path: {dw.launches} dw_bn_swish launches over {REQUESTS} requests")
    predicted = min(int(out.argmax(1).unique().numel()) for out in outs)
    for i, (x, out) in enumerate(zip(requests, outs)):
        ref = plain(x)
        check(out.shape == (batch, IMNET_CLASSES) and bool(torch.isfinite(out).all()),
              f"{name} request {i}: bad output {tuple(out.shape)}")
        dev = float((out.sum(1) - 1).abs().max())
        check(dev < 1e-4, f"{name} request {i}: leaf probs sum to 1 only within {dev:.3g}")
        agree, ties, raw = argmax_agreement(out.log(), ref.log(), TOL)
        check(agree == 1.0, f"{name} request {i}: fused vs plain argmax agreement {agree}")
        print(f"{tag} {name} request {i}: fused vs plain argmax {agree} ({ties} tie rows, "
              f"raw {raw}), max |prob diff| {float((out - ref).abs().max()):.3g}, max |sum - 1| "
              f"{dev:.3g}, {int(out.argmax(1).unique().numel())} of {IMNET_CLASSES} classes "
              "predicted", flush=True)
    del outs, ref
    check(dw.launches == launches["dw_bn_swish"], f"{name}: the library side ran dw_bn_swish")
    print(f"{tag} {name} launches over {REQUESTS} requests: {json.dumps(launches)}; "
          f"soft_head {st.last_launch['plan']}, grid {st.last_launch['grid']}", flush=True)
    with torch.no_grad():
        feats = fused.model(requests[0].permute(0, 3, 1, 2), features_only=True)
    check(feats.shape == (batch, dim) and feats.dtype == torch.float32,
          f"{name} features {tuple(feats.shape)} {feats.dtype}")
    head_err = gate_soft_head(feats, fused._head, True,
                              f"soft_head on {name} request 0 features B={batch} D={dim} "
                              f"C={IMNET_CLASSES}", tag, exact=True)
    _, decisions = plain.forward_with_decisions(requests[0][:2])
    path = " -> ".join(f"{s['name']} ({s['prob']:.3f})" for s in decisions[0])
    print(f"{tag} {name} decision path of image 0 ({len(decisions[0])} steps): {path}",
          flush=True)
    x = requests[0]
    print_profile(f"{name} fused f32 request of {batch} at {img}px",
                  *profile_ms(lambda: fused(x), n=2))
    rec = {"batch": batch, "image": img, "features": dim, "classes": IMNET_CLASSES,
           "requests": REQUESTS, "requests_timed": IMNET_TIMED, "launches": launches,
           "soft_head_leaf_err": head_err, "classes_predicted": predicted,
           "fused_ms_per_request": time_cuda(lambda: fused(x), n=IMNET_TIMED, warmup=1),
           "fused_wall_ms_per_request": wall_ms(lambda: fused(x), n=IMNET_TIMED, warmup=1),
           "plain_ms_per_request": time_cuda(lambda: plain(x), n=IMNET_TIMED, warmup=1)}
    return rec, fused, plain, feats


def serve_bf16(name: str, model, tree: Tree, plain, batch: int, img: int, seed: int,
               fold_bn: bool, tag: str) -> tuple:
    """``make_serving_fn(bf16=True, uint8_input=True)`` with ImageNet's
    normalization (and ``fold_bn``) on seeded uint8 images: finite leaf
    probabilities that sum to 1, its argmax agreement with the f32 plain
    path (reported here; the caller gates it where it may) and its time.
    Returns the record, the images, the f32 plain path's output on them and
    its top-1 indices."""
    u8 = imagenet_images(batch, img, torch.Generator(device="cuda").manual_seed(seed))
    ref = plain(imagenet_normalize(u8))
    serve = make_serving_fn(model, tree, bf16=True, fold_bn=fold_bn, uint8_input=True,
                            normalize=(IMAGENET_MEAN, IMAGENET_STD))
    served = serve(u8)
    check(served.shape == (batch, IMNET_CLASSES) and bool(torch.isfinite(served).all()),
          f"{name} serving fn: bad output")
    dev = float((served.sum(1) - 1).abs().max())
    check(dev < 1e-4, f"{name} serving fn: leaf probs sum to 1 only within {dev:.3g}")
    top = ref.argmax(1, keepdim=True)
    raw = float((served.argmax(1) == ref.argmax(1)).float().mean())
    diff = float((served.gather(1, top).log() - ref.gather(1, top).log()).abs().max())
    kind = "bf16+fold_bn+uint8" if fold_bn else "bf16+uint8"
    print(f"{tag} {name} {kind} vs f32 plain: argmax agreement {raw}, max |diff| "
          f"of the f32 top-1 leaf log-prob {diff:.4g}"
          + (f" (floor {IMNET_BF16_AGREE})" if fold_bn
             else " (reported, not gated: bf16 rounding on random weights)"), flush=True)
    key = f"serving_{kind.replace('+', '_')}"
    rec = {f"{key}_argmax_agreement": raw,
           f"{key}_ms_per_request": time_cuda(lambda: serve(u8), n=IMNET_TIMED, warmup=1)}
    return rec, u8, ref, top


def check_cli_eval(arch: str, hierarchy: str, tree: Tree, workdir: Path, tag: str) -> dict:
    """The CLI's ``--arch ARCH --dataset Imagenet1000 --synthetic --eval
    --hierarchy HIERARCHY --analysis SoftEmbeddedDecisionRules`` at 224px,
    batch IMNET_CLI_BATCH: its NBDT-Soft count equal to the plain rules' on
    ``tree`` over the logits of the same seeded backbone, and no kernel
    launch."""
    from nbdt_torch.main import build_datasets, get_parser
    from nbdt_torch.models import get_model
    from nbdt_torch.trainer import make_eval_step

    t0 = time.perf_counter()
    argv = ["--arch", arch, "--dataset", "Imagenet1000", "--synthetic", "--eval",
            "--hierarchy", hierarchy, "--analysis", "SoftEmbeddedDecisionRules",
            "--batch-size", str(IMNET_CLI_BATCH), "--no-progress", "--checkpoint-dir",
            str(workdir)]
    reset_launches()
    acc, text = run_cli(argv)
    torch.cuda.synchronize()
    cli_launches = read_launches()
    _, correct, total = nbdt_line(text, "NBDT-Soft")
    _, testset = build_datasets(get_parser().parse_args(argv))
    torch.manual_seed(0)  # the CLI's seed for its backbone
    model = get_model(arch, IMNET_CLASSES).to("cuda", memory_format=torch.channels_last)
    step = make_eval_step(model, "cuda")
    logits, labels = [], []
    for x, y, v in DataLoader(testset, IMNET_CLI_BATCH, transform=testset.transform_val(),
                              drop_last=False, pad_last=True):
        logits.append(step(torch.as_tensor(x, device="cuda"))[torch.as_tensor(v)])
        labels.append(torch.as_tensor(y)[torch.as_tensor(v)])
    logits, labels = torch.cat(logits), torch.cat(labels).cuda()
    rules = SoftAnalyzer(tree=tree).rules
    hits = int((rules.forward(logits).argmax(1) == labels).sum())
    check((correct, total) == (hits, len(labels)) and total == 2 * IMNET_CLI_BATCH,
          f"CLI {arch}: NBDT-Soft {correct}/{total}, the plain rules on the same "
          f"logits {hits}/{len(labels)}")
    check(cli_launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"CLI {arch} eval launched kernels: {cli_launches}")
    rec = {"arch": arch, "image": 224, "batch": IMNET_CLI_BATCH, "backbone_acc": acc,
           "nbdt_soft_correct": correct, "total": total, "launches": cli_launches,
           "seconds": time.perf_counter() - t0}
    print(f"{tag} CLI {arch} --synthetic Imagenet1000 224px --eval --hierarchy {hierarchy} "
          f"--analysis SoftEmbeddedDecisionRules at batch {IMNET_CLI_BATCH}: backbone "
          f"{acc:.2f}%, NBDT-Soft {correct}/{total}, equal to the plain rules on the same seeded "
          f"logits; {rec['seconds']:.1f} s", flush=True)
    del model, step, logits
    shutil.rmtree(workdir, ignore_errors=True)
    return rec


def run_imagenet_path(trees: dict, workdir: Path) -> dict:
    """The ImageNet path (BASELINE.json config #4, ROADMAP A3), f32 with
    TF32 off, seeded random weights, on the Imagenet1000 induced trees:
    EfficientNet-B7b at 600px (3 requests of 64) and resnet50 at 224px (3
    requests of 256) through SoftNBDT(fused=True), each against the plain
    rules with B1 on its own features (``serve_imagenet``); B7b's bf16
    serving fn with uint8 input (reported), resnet50's folded bf16 one
    (gated on argmax against the f32 plain path); then the CLI's
    ``--arch efficientnet_b7b --synthetic --eval --analysis
    SoftEmbeddedDecisionRules`` at 224px, its NBDT count equal to the plain
    rules' on the logits of the same seeded backbone. Returns the records
    and B1's timings on each path's head."""
    from nbdt_torch.models import efficientnet_b7b, resnet50

    out, heads = {}, {}
    for name, ctor, tree, batch, img, dim, seed, passes, dw_passes in (
            ("efficientnet_b7b", efficientnet_b7b, trees["b7b"], EFF_BATCH, EFF_IMG, EFF_DIM, 70,
             0, EFF_DW_PER_REQUEST),
            ("resnet50", resnet50, trees["resnet"], R50_BATCH, R50_IMG, R50_DIM, 80,
             R50_BN_ACT_PER_REQUEST, 0)):
        t0 = time.perf_counter()
        model = imagenet_model(ctor, img, seed)
        rec, fused, plain, feats = serve_imagenet(name, model, tree, batch, img, dim, seed + 3,
                                                  bn_act_per_request=passes,
                                                  dw_per_request=dw_passes)
        fold = name == "resnet50"
        srv, u8, ref, top = serve_bf16(name, model, tree, plain, batch, img, seed + 4, fold,
                                       "[imagenet serving]")
        if fold:
            raw = srv["serving_bf16_fold_bn_uint8_argmax_agreement"]
            check(raw >= IMNET_BF16_AGREE, f"{name} folded bf16 serving fn: argmax agreement "
                                           f"{raw} with the f32 plain path")
            f32_fold = make_serving_fn(model, tree, bf16=False, fold_bn=True, uint8_input=True,
                                       normalize=(IMAGENET_MEAN, IMAGENET_STD))(u8)
            agree, ties, raw32 = argmax_agreement(f32_fold.log(), ref.log(), TOL)
            diff32 = float((f32_fold.gather(1, top).log() - ref.gather(1, top).log()).abs().max())
            print(f"[imagenet serving] {name} f32+fold_bn+uint8 vs f32 plain: argmax {agree} on "
                  f"rows whose top-2 gap exceeds {TOL} ({ties} rows within it, raw {raw32}), max "
                  f"|diff| of the top-1 leaf log-prob {diff32:.4g}", flush=True)
            check(agree == 1.0, f"{name} f32 folded serving fn: argmax agreement {agree}")
            rec["serving_f32_fold_bn_uint8_argmax_agreement"] = raw32
            del f32_fold
        rec.update({**srv, "seconds": time.perf_counter() - t0})
        heads[name] = time_path_head(feats, fused._head,
                                     f"{name} head B={batch} D={dim} C={IMNET_CLASSES}")
        out[name] = rec
        del model, fused, plain, feats, u8, ref
        torch.cuda.empty_cache()

    # The CLI: the NBDT count equal to the plain rules' on the same seeded logits
    out["cli"] = check_cli_eval("efficientnet_b7b", "induced-efficientnet_b7b", trees["b7b"],
                                workdir, "[imagenet]")
    return {"paths": out, "heads": heads}


def run_zoo_path(tree: Tree, workdir: Path) -> dict:
    """The zoo path (ROADMAP A14), f32 with TF32 off, seeded random weights
    (``imagenet_model``: BatchNorm statistics and the classifier the probe
    finds calibrated), on the Imagenet1000 induced tree: each of ZOO_PATHS,
    3 requests of 256 through SoftNBDT(fused=True) against the plain rules,
    B1 on its own features (``serve_imagenet``), more than one class
    predicted, its bf16 + uint8 serving fn (reported) and B1's time on its
    head; SqueezeNet-1.1, 3 requests of 256 through the plain rules with no
    launch, its fused wrapper raising NotImplementedError; one forward of
    each of ZOO_NAMES at batch 2 (Inception v3 at 299px, the rest at 224px):
    finite logits [2, 1000]; then the CLI's ``--arch mobilenet_v2 --eval``,
    its NBDT count equal to the plain rules'. Returns the records and B1's
    timings on each head."""
    from nbdt_torch.models import get_model

    out, heads = {}, {}
    for i, (arch, kw, img, dim) in enumerate(ZOO_PATHS):
        t0 = time.perf_counter()
        seed = 100 + 10 * i
        model = imagenet_model(lambda n: get_model(arch, n, **kw), img, seed, ZOO_SD_FLOOR)
        rec, fused, plain, feats = serve_imagenet(arch, model, tree, ZOO_BATCH, img, dim,
                                                  seed + 3, "[zoo]")
        check(rec["classes_predicted"] > 1, f"{arch}: one class predicted for every image")
        srv, u8, ref, _ = serve_bf16(arch, model, tree, plain, ZOO_BATCH, img, seed + 4, False,
                                     "[zoo serving]")
        rec.update({**kw, **srv, "seconds": time.perf_counter() - t0})
        heads[arch] = time_path_head(feats, fused._head,
                                     f"{arch} head B={ZOO_BATCH} D={dim} C={IMNET_CLASSES}")
        out[arch] = rec
        print(f"[zoo] {arch} at {img}px: fused {rec['fused_ms_per_request']:.3f} ms a request "
              f"(host clock {rec['fused_wall_ms_per_request']:.3f}), plain "
              f"{rec['plain_ms_per_request']:.3f}, bf16 + uint8 serving "
              f"{srv['serving_bf16_uint8_ms_per_request']:.3f}; {rec['seconds']:.1f} s",
              flush=True)
        del model, fused, plain, feats, u8, ref
        torch.cuda.empty_cache()
    out["squeezenet1_1"] = run_squeezenet(tree)
    out["every_name"] = forward_every_name()
    out["cli"] = check_cli_eval("mobilenet_v2", "induced", tree, workdir, "[zoo]")
    return {"paths": out, "heads": heads}


def run_squeezenet(tree: Tree) -> dict:
    """SqueezeNet-1.1 at 224px: 3 requests of 256 through the plain rules
    (no kernel launch), finite leaf probabilities summing to 1 over more
    than one predicted class; SoftNBDT(fused=True) raises
    NotImplementedError (its logits are no linear function of pooled
    features); its bf16 + uint8 serving fn, reported."""
    from nbdt_torch.models import squeezenet1_1

    t0, name, seed = time.perf_counter(), "squeezenet1_1", 190
    model = imagenet_model(squeezenet1_1, 224, seed, ZOO_SD_FLOOR)
    plain = SoftNBDT("Imagenet1000", model, tree=tree)
    cgen = torch.Generator(device="cuda").manual_seed(seed + 3)
    requests = [imagenet_normalize(imagenet_images(ZOO_BATCH, 224, cgen))
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    reset_launches()
    outs = [plain(x) for x in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"{name} plain path launched kernels: {launches}")
    for i, o in enumerate(outs):
        check(o.shape == (ZOO_BATCH, IMNET_CLASSES) and bool(torch.isfinite(o).all()),
              f"{name} request {i}: bad output")
        dev = float((o.sum(1) - 1).abs().max())
        check(dev < 1e-4, f"{name} request {i}: leaf probs sum to 1 only within {dev:.3g}")
    predicted = min(int(o.argmax(1).unique().numel()) for o in outs)
    check(predicted > 1, f"{name}: one class predicted for every image")
    fused = SoftNBDT("Imagenet1000", model, tree=tree, fused=True)
    try:
        fused(requests[0])
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    check(refused is not None, f"{name}: SoftNBDT(fused=True) served without pooled features")
    x = requests[0]
    print_profile(f"{name} plain f32 request of {ZOO_BATCH} at 224px",
                  *profile_ms(lambda: plain(x), n=2))
    rec = {"batch": ZOO_BATCH, "image": 224, "classes": IMNET_CLASSES, "requests": REQUESTS,
           "launches": launches, "classes_predicted": predicted, "fused_refused": refused,
           "plain_ms_per_request": time_cuda(lambda: plain(x), n=IMNET_TIMED, warmup=1),
           "plain_wall_ms_per_request": wall_ms(lambda: plain(x), n=IMNET_TIMED, warmup=1)}
    srv, *_ = serve_bf16(name, model, tree, plain, ZOO_BATCH, 224, seed + 4, False,
                         "[zoo serving]")
    rec.update({**srv, "seconds": time.perf_counter() - t0})
    print(f"[zoo] {name} plain rules at 224px: {rec['plain_ms_per_request']:.3f} ms a request "
          f"(host clock {rec['plain_wall_ms_per_request']:.3f}), 0 launches, {predicted} classes "
          f"predicted at least; SoftNBDT(fused=True) refused: NotImplementedError; "
          f"{rec['seconds']:.1f} s", flush=True)
    return rec


def forward_every_name() -> dict:
    """Each of the zoo's 26 names built on the card with its default init
    (seeded) and run once in eval mode at batch 2: finite logits [2, 1000].
    Returns the image size and seconds of each."""
    from nbdt_torch.models import get_model

    t0, out = time.perf_counter(), {}
    g = torch.Generator(device="cuda").manual_seed(5)
    for i, arch in enumerate(ZOO_NAMES):
        img = 299 if arch == "inception_v3" else 224
        t1 = time.perf_counter()
        torch.manual_seed(200 + i)
        with torch.device("cuda"):
            model = get_model(arch, IMNET_CLASSES)
        model = model.to(memory_format=torch.channels_last).eval()
        x = imagenet_normalize(imagenet_images(2, img, g))
        with torch.no_grad():
            logits = model(x.permute(0, 3, 1, 2))
        torch.cuda.synchronize()
        check(logits.shape == (2, IMNET_CLASSES) and bool(torch.isfinite(logits).all()),
              f"{arch}: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
        out[arch] = {"image": img, "seconds": time.perf_counter() - t1}
        del model
    torch.cuda.empty_cache()
    print(f"[zoo] each of the {len(ZOO_NAMES)} names built on the card and ran a batch of 2: "
          f"finite logits [2, {IMNET_CLASSES}]; {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def leaf_gate(got: torch.Tensor, want: torch.Tensor, rows: int, classes: int, case: str) -> dict:
    """Finite leaves of the expected shape whose argmax agrees with
    ``want``'s on every row decided by more than TOL (top-2 leaf
    probabilities); returns the agreement and the largest difference."""
    check(got.shape == (rows, classes) and bool(torch.isfinite(got).all()),
          f"{case}: bad output {tuple(got.shape)}")
    agree, ties, raw = argmax_agreement(got, want, TOL)
    err = float((got - want).abs().max())
    print(f"[export] {case}: argmax agreement {agree} ({ties} tie rows, raw {raw}), max |leaf "
          f"prob diff| {err:.3g}", flush=True)
    check(agree == 1.0, f"{case}: argmax agreement {agree}")
    return {"argmax_agreement": agree, "tie_rows": ties, "max_leaf_diff": err}


def loaded_program(path: Path) -> tuple:
    """(4-d weights in the saved program, how many of them are channels-last
    as ``torch.export.load`` gives them back, the batch range its graph
    allows)."""
    program = torch.export.load(str(path))
    weights = [v for v in program.state_dict.values() if v.dim() == 4]
    return (len(weights), sum(v.is_contiguous(memory_format=torch.channels_last) for v in weights),
            str(next(iter(program.range_constraints.values()))))


def export_flagship(model, tree: Tree, workdir: Path, cgen: torch.Generator) -> dict:
    """(a) the flagship artifact: ResNet18 bf16 + fold_bn + uint8 at 32px,
    exported, loaded and run at batches 1, 7 and 8192 against the live
    serving fn; 3 requests of 8192 timed beside it. (b) the same file run
    in a process that imports torch and nothing of the repository."""
    flags = {"bf16": True, "fold_bn": True, "uint8_input": True}
    live = make_serving_fn(model, tree, **flags)
    path = workdir / "resnet18_bf16_folded_uint8.pt2"
    t0 = time.perf_counter()
    export_serving(model, tree, str(path), 32, **flags)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = load_serving(str(path))
    load_s = time.perf_counter() - t0
    n_convs, n_cl, batches = loaded_program(path)
    rec = {"bytes": path.stat().st_size, "export_s": export_s, "load_s": load_s,
           "conv_weights": n_convs, "conv_weights_channels_last": n_cl, "batch_range": batches}
    print(f"[export] (a) ResNet18 bf16+fold_bn+uint8 artifact: {rec['bytes']} bytes, export "
          f"{export_s:.2f} s, load {load_s:.2f} s; {n_cl} of {n_convs} conv weights "
          f"channels-last after torch.export.load; batch range {batches}", flush=True)
    for b in EXPORT_BATCHES:
        u8 = torch.randint(0, 256, (b, 32, 32, 3), dtype=torch.uint8, device="cuda",
                           generator=cgen)
        rec[f"batch_{b}"] = leaf_gate(served(u8), live(u8), b, 10, f"(a) artifact batch {b}")
    rec["artifact_ms_per_request"] = time_cuda(lambda: served(u8), n=REQUESTS)
    rec["live_ms_per_request"] = time_cuda(lambda: live(u8), n=REQUESTS)
    print(f"[export] (a) request of {BATCH}: artifact {rec['artifact_ms_per_request']:.3f} ms, "
          f"live serving fn {rec['live_ms_per_request']:.3f} ms (CUDA events, {REQUESTS} "
          "requests)", flush=True)

    # (b) self-containment: torch alone, "highest" set by the caller
    leaves = served(u8)
    torch.save(u8.cpu(), workdir / "request.pt")
    code = (
        "import sys, torch\n"
        "torch.set_float32_matmul_precision('highest')\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        f"program = torch.export.load({path.name!r}).module()\n"
        "with torch.no_grad():\n"
        "    out = program(torch.load('request.pt').cuda())\n"
        "torch.save(out.cpu(), 'leaves.pt')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('nbdt_torch', 'nbdt_tpu', "
        "'jax', 'flax')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=workdir, env=env,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"(b) torch-only process failed: {proc.stderr[-2000:]}")
    check(proc.stdout.strip() == "[]", f"(b) the process imported {proc.stdout.strip()}")
    err = float((torch.load(workdir / "leaves.pt") - leaves.cpu()).abs().max())
    print(f"[export] (b) torch.export.load(...).module() in a process with torch alone "
          f"({time.perf_counter() - t0:.1f} s): max |leaf diff| {err:.3g} against (a) "
          f"(limit {EXPORT_TOL})", flush=True)
    check(err <= EXPORT_TOL, f"(b) leaves differ from (a)'s by {err}")
    rec["torch_only_max_leaf_diff"] = err
    return rec


def export_exactness(model, tree: Tree, workdir: Path, cgen: torch.Generator) -> dict:
    """(c) an f32 artifact called under the caller's "medium" precision: its
    two tree products run at "highest" (PrecisionSpy), and its leaves equal
    the same call under "highest"."""
    path = workdir / "resnet18_f32.pt2"
    export_serving(model, tree, str(path), 32, bf16=False)
    served = load_serving(str(path))
    batches = loaded_program(path)[2]
    x = torch.randn(EXPORT_EXACT_BATCH, 32, 32, 3, device="cuda", generator=cgen)
    S = tree.arrays.num_inodes * tree.arrays.max_children
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        spy = PrecisionSpy()
        with spy:
            got = served(x)
        torch.cuda.synchronize()
        check(torch.get_float32_matmul_precision() == "medium",
              "(c) load_serving did not restore the caller's precision")
        torch.set_float32_matmul_precision("highest")
        want = served(x)
    finally:
        torch.set_float32_matmul_precision(prev)
    products = [prec for shapes, prec in spy.calls if any(S in shape for shape in shapes)]
    err = float((got - want).abs().max())
    print(f"[export] (c) f32 artifact (batch range {batches}) under the caller's \"medium\": "
          f"tree products at {products}, all matmuls at {sorted({p for _, p in spy.calls})}; "
          f"max |leaf diff| {err:.3g} against the call under \"highest\" (limit {EXPORT_TOL})",
          flush=True)
    check(products == ["highest", "highest"], f"(c) tree products ran at {products}")
    check(err <= EXPORT_TOL, f"(c) leaves under \"medium\" differ by {err}")
    return {"tree_products": products, "max_leaf_diff": err, "batch_range": batches}


def export_aot(model, tree: Tree, cgen: torch.Generator) -> dict:
    """(d) aot_compile of the flagship serving fn at batch 8192, uint8
    input: the graph count under torch._dynamo.explain (gated at 1), the
    compile seconds, argmax agreement with the live fn, 3 requests timed."""
    live = make_serving_fn(model, tree, bf16=True, fold_bn=True, uint8_input=True)
    u8 = torch.randint(0, 256, (BATCH, 32, 32, 3), dtype=torch.uint8, device="cuda",
                       generator=cgen)
    torch._dynamo.reset()
    explained = torch._dynamo.explain(live)(u8)
    graphs, breaks = explained.graph_count, explained.graph_break_count
    torch._dynamo.reset()
    t0 = time.perf_counter()
    compiled = aot_compile(live, BATCH, 32, dtype=torch.uint8)
    compile_s = time.perf_counter() - t0
    print(f"[export] (d) aot_compile at batch {BATCH}: {graphs} graph(s), {breaks} break(s) "
          f"under torch._dynamo.explain; compile and warm-up {compile_s:.1f} s", flush=True)
    check(graphs == 1, f"(d) the serving fn compiles to {graphs} graphs")
    rec = {"graphs": graphs, "graph_breaks": breaks, "compile_s": compile_s}
    rec.update(leaf_gate(compiled(u8), live(u8), BATCH, 10, "(d) aot_compile"))
    rec["aot_ms_per_request"] = time_cuda(lambda: compiled(u8), n=REQUESTS)
    rec["live_ms_per_request"] = time_cuda(lambda: live(u8), n=REQUESTS)
    print(f"[export] (d) request of {BATCH}: aot_compile {rec['aot_ms_per_request']:.3f} ms, "
          f"live serving fn {rec['live_ms_per_request']:.3f} ms", flush=True)
    for key, fn in (("live", live), ("aot", compiled)):
        wall, device, ops, seen = profile_ms(lambda: fn(u8), n=REQUESTS)
        print_profile(f"ResNet18 {key} serving fn request of {BATCH}", wall, device, ops, seen)
        rec[f"{key}_device_busy_ms"] = sum(device.values())
        rec[f"{key}_kernels_per_request"] = sum(seen.values()) / REQUESTS
    return rec


def seeded_wrn_cifar10() -> torch.nn.Module:
    """WRN-28-10 for CIFAR10 (the released checkpoint's arch and the nbdt
    CLI's default) on the card: seeded BatchNorms, calibrated classifier."""
    gen = torch.Generator().manual_seed(50)
    torch.manual_seed(50)
    model = wrn28_10_cifar10()
    randomize_batchnorm(model, gen)
    cgen = torch.Generator(device="cuda").manual_seed(51)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    calibrate_classifier(model, model.output,
                         torch.randn(WRN_BATCH, 32, 32, 3, device="cuda", generator=cgen), gen)
    return model


def export_cli(model, tree: Tree, workdir: Path, pth: Path, cgen: torch.Generator) -> dict:
    """(e) ``python -m nbdt_torch.bin.nbdt_export --arch wrn28_10_cifar10
    --checkpoint <pth> --uint8-input`` in this process (bf16 by default),
    then 3 requests of 1024 through the artifact against the live serving
    fn on the same weights, both timed."""
    from nbdt_torch.bin.nbdt_export import main as export_main
    from nbdt_torch.data import CIFAR10

    path = workdir / "wrn.pt2"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        export_main(["--arch", "wrn28_10_cifar10", "--dataset", "CIFAR10", "--checkpoint",
                     str(pth), "--uint8-input", "--out", str(path)])
    export_s = time.perf_counter() - t0
    print(f"[export] (e) {buf.getvalue().strip()} in {export_s:.1f} s", flush=True)
    check(buf.getvalue().startswith("==> Exported wrn28_10_cifar10/CIFAR10 serving artifact"),
          "(e) the export CLI printed no ==> Exported line")
    served = load_serving(str(path))
    live = make_serving_fn(model, tree, bf16=True, uint8_input=True,
                           normalize=(CIFAR10.mean, CIFAR10.std))
    n_convs, n_cl, batches = loaded_program(path)
    rec = {"bytes": path.stat().st_size, "export_s": export_s, "conv_weights": n_convs,
           "conv_weights_channels_last": n_cl, "batch_range": batches}
    for i in range(REQUESTS):
        u8 = torch.randint(0, 256, (WRN_BATCH, 32, 32, 3), dtype=torch.uint8, device="cuda",
                           generator=cgen)
        rec[f"request_{i}"] = leaf_gate(served(u8), live(u8), WRN_BATCH, 10,
                                        f"(e) WRN-28-10 artifact request {i}")
    rec["artifact_ms_per_request"] = time_cuda(lambda: served(u8), n=REQUESTS)
    rec["live_ms_per_request"] = time_cuda(lambda: live(u8), n=REQUESTS)
    print(f"[export] (e) WRN-28-10 request of {WRN_BATCH}: artifact "
          f"{rec['artifact_ms_per_request']:.3f} ms, live serving fn "
          f"{rec['live_ms_per_request']:.3f} ms; {n_cl} of {n_convs} conv weights channels-last; "
          f"batch range {batches}", flush=True)
    return rec


@contextlib.contextmanager
def release_cache(cache: Path):
    """NBDT_CHECKPOINT_DIR set to ``cache`` and every download refused, for
    the block: a lookup must find its file there."""
    import nbdt_torch.models.utils as ckpt_utils

    def no_download(url, dest):
        raise RuntimeError(f"tried to download {url}")

    prev_dir, prev_download = os.environ.get("NBDT_CHECKPOINT_DIR"), ckpt_utils.download_checkpoint
    os.environ["NBDT_CHECKPOINT_DIR"] = str(cache)
    ckpt_utils.download_checkpoint = no_download
    try:
        yield
    finally:
        ckpt_utils.download_checkpoint = prev_download
        if prev_dir is None:
            os.environ.pop("NBDT_CHECKPOINT_DIR")
        else:
            os.environ["NBDT_CHECKPOINT_DIR"] = prev_dir


def export_pretrained(model, pth: Path, workdir: Path, cgen: torch.Generator) -> dict:
    """(f) the seeded WRN .pth placed under the released file name of
    ("wrn28_10_cifar10", "CIFAR10") in a fresh NBDT_CHECKPOINT_DIR: the nbdt
    CLI's model builder loads it with no path and no download; its decision
    line and nbdt-original's prediction for one normalized image, each
    equal to the model's own argmax. Where PIL is installed, both CLIs also
    run end to end on a seeded PNG."""
    import importlib.util

    from nbdt_torch import model_urls
    from nbdt_torch.bin.nbdt import build_model, decision_line
    from nbdt_torch.bin.original import load_backbone, prediction
    from nbdt_torch.utils import DATASET_TO_CLASSES

    cache = workdir / "cache"
    cache.mkdir()
    name = model_urls[("wrn28_10_cifar10", "CIFAR10")].rsplit("/", 1)[-1]
    shutil.copy(pth, cache / name)
    with release_cache(cache):
        nbdt = build_model("wrn28_10_cifar10", "CIFAR10")
    u8 = torch.randint(0, 256, (1, 32, 32, 3), dtype=torch.uint8, device="cuda", generator=cgen)
    x = (u8.float() / 255.0 - torch.as_tensor(CIFAR_MEAN, device="cuda")) / torch.as_tensor(
        CIFAR_STD, device="cuda")
    with torch.no_grad():
        logits = model(x.permute(0, 3, 1, 2))
    classes = DATASET_TO_CLASSES["CIFAR10"]
    line = decision_line(nbdt, x)
    want = SoftNBDT("CIFAR10", model, arch="wrn28_10_cifar10")(x).argmax(1)
    print(f"[export] (f) nbdt, SoftNBDT(pretrained=True) from {cache / name}: {line}", flush=True)
    check(line.startswith(f"Prediction: {nbdt.tree.classes[int(want)]} // Decisions: "),
          f"(f) the decision line disagrees with the model's NBDT argmax {int(want)}")
    original = prediction(load_backbone("wrn28_10_cifar10", "CIFAR10", str(cache / name)), x,
                          "CIFAR10")
    print(f"[export] (f) nbdt-original: Prediction: {original}", flush=True)
    check(original == classes[int(logits.argmax(1))],
          f"(f) nbdt-original predicted {original}, the backbone {int(logits.argmax(1))}")
    rec = {"decision_line": line, "original": original,
           "pil": importlib.util.find_spec("PIL") is not None}
    if not rec["pil"]:
        print("[export] (f) no PIL on this machine: the image decode of the two CLIs is held "
              "on the CPU only (tests/test_torch_cli.py)", flush=True)
        return rec
    # PIL is here: both CLIs end to end on a seeded PNG, the decision line
    # equal to the builder's on the CLI's own preprocessing
    from PIL import Image

    from nbdt_torch.bin.nbdt import main as nbdt_main
    from nbdt_torch.bin.nbdt import preprocess
    from nbdt_torch.bin.original import main as original_main
    from nbdt_torch.utils import load_image_from_path

    png = workdir / "image.png"
    pixels = torch.randint(0, 256, (40, 48, 3), dtype=torch.uint8, generator=torch.Generator()
                           .manual_seed(52)).numpy()
    Image.fromarray(pixels).save(png)
    buf = io.StringIO()
    with release_cache(cache), contextlib.redirect_stdout(buf):
        nbdt_main([str(png)])
        original_main([str(png), "--checkpoint", str(cache / name)])
    cli_line, cli_original = buf.getvalue().strip().splitlines()
    x = preprocess(load_image_from_path(str(png)))
    print(f"[export] (f) PIL is on this machine: python -m nbdt_torch.bin.nbdt image.png: "
          f"{cli_line}; nbdt_torch.bin.original: {cli_original}", flush=True)
    check(cli_line == decision_line(nbdt, x), "(f) the nbdt CLI's line differs from the builder's")
    with torch.no_grad():
        png_logits = model(torch.as_tensor(x, device="cuda").permute(0, 3, 1, 2))
    check(cli_original == f"Prediction: {classes[int(png_logits.argmax(1))]}",
          f"(f) nbdt-original printed {cli_original!r}")
    rec.update({"cli_decision_line": cli_line, "cli_original": cli_original})
    return rec


def run_export_path(workdir: Path) -> dict:
    """The export path (ROADMAP A12): (a)-(d) on the main path's ResNet18
    (CIFAR10 induced tree, 32px), (e)-(f) on a seeded WRN-28-10 for CIFAR10
    written to a .pth, each artifact under ``workdir``. Returns each
    phase's record and the kernel launches (none expected: the serving fns
    and artifacts run the plain rules, the CLIs forward_with_decisions)."""
    if workdir.exists():
        shutil.rmtree(workdir)
    workdir.mkdir(parents=True)
    tree = Tree("CIFAR10")
    model = seeded_resnet18(torch.Generator(device="cuda").manual_seed(1))
    cgen = torch.Generator(device="cuda").manual_seed(40)
    torch.cuda.synchronize()
    reset_launches()
    out = {"flagship": export_flagship(model, tree, workdir, cgen),
           "exact": export_exactness(model, tree, workdir, cgen),
           "aot": export_aot(model, tree, cgen)}
    del model
    wrn = seeded_wrn_cifar10()
    pth = workdir / "wrn28_10_cifar10_seeded.pth"
    torch.save({k: v.cpu() for k, v in wrn.state_dict().items()}, pth)
    out["cli"] = export_cli(wrn, Tree("CIFAR10", hierarchy="induced-wrn28_10_cifar10"),
                            workdir, pth, cgen)
    out["pretrained"] = export_pretrained(wrn, pth, workdir, cgen)
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    print(f"[export] kernel launches over the export path: {json.dumps(out['launches'])}",
          flush=True)
    check(out["launches"] == {"soft_head": 0, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"export path launches {out['launches']}")
    del wrn
    torch.cuda.empty_cache()
    return out


# (d)'s worker: one of two ranks sharing the card over gloo (NCCL refuses
# two ranks on one device). It imports torch and nbdt_torch only.
PAR_WORKER = r"""
import json, sys, time
from pathlib import Path
workdir, rank = Path(sys.argv[1]), int(sys.argv[2])
import torch
import torch.distributed as dist
from nbdt_torch.data import DataLoader, LearnableSyntheticDataset
from nbdt_torch.models import ResNet18
from nbdt_torch.parallel import initialize_multihost, make_mesh
from nbdt_torch.serving import make_serving_fn, shard_serving
from nbdt_torch.trainer import TrainConfig, Trainer
from nbdt_torch.tree import Tree

args = json.loads((workdir / "args.json").read_text())
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True  # (d) is a comparison
world = initialize_multihost(f"file://{workdir / 'store'}", 2, rank, backend="gloo")
mesh = make_mesh()
out = {"world": world, "backend": dist.get_backend(), "device": torch.cuda.current_device()}


def model(name):
    m = ResNet18(10)
    m.load_state_dict(torch.load(workdir / name, weights_only=True))
    return m


testset = LearnableSyntheticDataset(10, size=args["batch"], seed=0, train=False)
testloader = DataLoader(testset, args["batch"], transform=testset.transform_val(),
                        drop_last=False, pad_last=True)
cfg = TrainConfig(dataset="CIFAR10", arch="ResNet18", batch_size=args["batch"], epochs=2,
                  loss="SoftTreeSupLoss", cache_dataset=True,
                  checkpoint_dir=str(workdir / "ckpt"))
for steps in args["steps"]:  # one epoch of that many global steps
    trainset = LearnableSyntheticDataset(10, size=steps * args["batch"], seed=0)
    loader = DataLoader(trainset, args["batch"], shuffle=True,
                        transform=trainset.transform_train())
    tr = Trainer(cfg, model("init.pth"), loader, testloader, tree=Tree("CIFAR10"), mesh=mesh)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses = tr.train_epoch(0)["step_losses"]
    end.record()
    torch.cuda.synchronize()
    out[f"losses{steps}"] = ["%.17g" % v for v in losses]
    out["ms_per_step"] = start.elapsed_time(end) / len(losses)
    torch.save({k: v.cpu() for k, v in tr.model.state_dict().items()},
               workdir / f"state{steps}_{rank}.pth")

fn = make_serving_fn(model("serve.pth"), Tree("CIFAR10"), bf16=True, fold_bn=True,
                     uint8_input=True)
sharded = shard_serving(fn, mesh)
gen = torch.Generator(device="cuda").manual_seed(args["seed"])
x = torch.randint(0, 256, (args["serve_batch"], 32, 32, 3), generator=gen, device="cuda",
                  dtype=torch.uint8)
live, got = fn(x), sharded(x)
top2 = live.topk(2, dim=1).values
decided = (top2[:, 0] - top2[:, 1]) > 1e-4
same = got.argmax(1) == live.argmax(1)
out["serving"] = {"shape": list(got.shape), "rows_decided": int(decided.sum()),
                  "agreement": float(same[decided].float().mean()),
                  "max_leaf_diff": float((got.float() - live.float()).abs().max())}
times = []
for _ in range(4):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded(x)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
out["serving"]["host_ms_per_request"] = sum(times[1:]) / 3
(workdir / f"rank{rank}.json").write_text(json.dumps(out))
dist.destroy_process_group()
"""


def launch_pair(workdir: Path, worker: str = PAR_WORKER, deadline: float = PAR_DEADLINE) -> list:
    """Runs ``worker`` as ranks 0 and 1; returns their results. Fails when
    either rank fails or the pair outlives ``deadline``: a rank that dies
    leaves its sibling blocked in a collective, so the sibling is killed."""
    script = workdir / "worker.py"
    script.write_text(worker)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(Path(__file__).resolve().parent),
                                                      env.get("PYTHONPATH")]))
    env["PYTHONUNBUFFERED"] = "1"  # a rank killed at the deadline keeps what it printed
    procs = [subprocess.Popen([sys.executable, str(script), str(workdir), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(2)]
    deadline = time.monotonic() + deadline
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(f"[pair] rank {r} exited {p.returncode}:\n{out[-4000:]}", flush=True)
    check(all(p.returncode == 0 for p in procs),
          f"{workdir.name}: ranks exited {[p.returncode for p in procs]}")
    return [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(2)]


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside (for the comparisons)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def timed_train(tr: Trainer, epochs: int, label: str) -> tuple:
    """``epochs`` epochs of ``tr``: every step's loss, and the device ms a
    step of the last epoch (CUDA events around it)."""
    losses, ms = [], None
    for epoch in range(epochs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step_losses = tr.train_epoch(epoch)["step_losses"]
        end.record()
        torch.cuda.synchronize()
        check(len(step_losses) > 0 and all(math.isfinite(v) for v in step_losses),
              f"{label} epoch {epoch}: step losses {step_losses}")
        losses += step_losses
        ms = start.elapsed_time(end) / len(step_losses)
    return losses, ms


def loss_gate(label: str, got: list, want: list) -> float:
    """Largest relative difference of two step-loss lists, gated at PAR_RTOL."""
    check(len(got) == len(want), f"{label}: {len(got)} steps against {len(want)}")
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    check(rel <= PAR_RTOL, f"{label}: step losses {got} against {want}")
    return rel


def trace_kernel_events(log_dir: Path) -> tuple:
    """(CUDA kernel events, all events, bytes) of the one trace in log_dir."""
    files = list(log_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"(e) traces written: {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    return kernels, len(events), files[0].stat().st_size


def run_parallel_path(workdir: Path) -> dict:
    """The parallel path (ROADMAP A13), config #2 at full width: ResNet18 on
    CIFAR10-shaped learnable synthetic data, SoftTreeSupLoss on the induced
    tree, batch 512, f32, TF32 off, cached. (a) ``make_mesh()`` forms a
    one-rank NCCL group and ``Trainer(mesh=...)`` trains beside ``Trainer()``
    from the same weights; (b) the same under ZeRO-1; (c) a ``.dcp``
    directory round trip; (d) two ranks sharing the card over gloo, 256 rows
    each, against the plain trainer on the same global batches, then
    ``shard_serving`` of the flagship serving fn at 8192; (e) ``--profile``'s
    trace; (f) the CLI with ``--mesh --zero --checkpoint-backend orbax``.
    No kernel launches (training and the serving fn run the plain rules)."""
    import torch.distributed as dist

    from nbdt_torch.parallel import make_mesh, state_bytes
    from nbdt_torch.profiling import trace

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    tree = Tree("CIFAR10")
    trainset = LearnableSyntheticDataset(10, size=TRAIN_SIZE, seed=0)
    testset = LearnableSyntheticDataset(10, size=TEST_SIZE, seed=0, train=False)
    testloader = DataLoader(testset, TRAIN_BATCH, transform=testset.transform_val(),
                            drop_last=False, pad_last=True)

    def loader(ds):
        return DataLoader(ds, TRAIN_BATCH, shuffle=True, transform=ds.transform_train())

    def config(**kw):
        return TrainConfig(dataset="CIFAR10", arch="ResNet18", batch_size=TRAIN_BATCH,
                           epochs=TRAIN_EPOCHS, loss="SoftTreeSupLoss", cache_dataset=True,
                           checkpoint_dir=str(workdir / "ckpt"), **kw)

    torch.manual_seed(20)
    init = ResNet18(10)
    torch.save(init.state_dict(), workdir / "init.pth")
    torch.save(seeded_resnet18(torch.Generator(device="cuda").manual_seed(60)).cpu()
               .state_dict(), workdir / "serve.pth")
    torch.cuda.synchronize()
    reset_launches()
    out = {}

    # (a) one rank on NCCL beside the plain trainer, (b) the same under ZeRO-1:
    # one epoch each compared, then two each timed (the second epoch's steps)
    mesh = make_mesh()
    check(dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1),
          f"(a) backend {dist.get_backend()}, mesh {tuple(mesh.shape)}")
    kinds = {"plain": {}, "mesh": {"mesh": mesh}, "zero": {"mesh": mesh, "zero": True}}
    compared, timed, trainers, default_losses = {}, {}, {}, {}
    with deterministic_cudnn():
        for kind, kw in kinds.items():
            tr = Trainer(config(), init, loader(trainset), testloader, tree=tree, **kw)
            compared[kind] = timed_train(tr, 1, f"({kind}) compared")[0]
    for kind, kw in [*kinds.items(), ("plain again", {})]:
        tr = Trainer(config(), init, loader(trainset), testloader, tree=tree, **kw)
        default_losses[kind], timed[kind] = timed_train(tr, TRAIN_EPOCHS, f"({kind}) timed")
        trainers[kind] = tr

    def parting(kind):  # largest relative difference from the plain losses
        return max(abs(a - b) / abs(b) for a, b in zip(default_losses[kind],
                                                        default_losses["plain"]))
    zero_bytes, plain_bytes = (state_bytes(trainers[k].optimizer) for k in ("zero", "plain"))
    rel = loss_gate("(a) mesh vs plain", compared["mesh"], compared["plain"])
    out["a"] = {"backend": "nccl", "steps_compared": len(compared["mesh"]),
                "max_rel_loss_diff": rel, "mesh_device_ms_per_step": timed["mesh"],
                "plain_device_ms_per_step": timed["plain"],
                "plain_again_device_ms_per_step": timed["plain again"],
                "default_cudnn_max_rel_loss_diff": {"plain_again": parting("plain again"),
                                                    "mesh": parting("mesh")}}
    print(f"[parallel] (a) one NCCL rank: {len(compared['mesh'])} cached steps at batch "
          f"{TRAIN_BATCH} with cuDNN deterministic, every loss within {rel:.3g} of the plain "
          f"trainer's (tolerance {PAR_RTOL}); epoch {TRAIN_EPOCHS - 1} with cuDNN's defaults: "
          f"mesh {timed['mesh']:.3f} device ms/step, plain {timed['plain']:.3f} and "
          f"{timed['plain again']:.3f}; over those {2 * len(compared['mesh'])} steps a second "
          f"plain run parts from the first by up to {parting('plain again'):.3g}, the mesh by "
          f"{parting('mesh'):.3g}", flush=True)
    rel = loss_gate("(b) zero vs plain", compared["zero"], compared["plain"])
    out["b"] = {"max_rel_loss_diff": rel, "device_ms_per_step": timed["zero"],
                "optimizer_state_bytes": zero_bytes, "plain_optimizer_state_bytes": plain_bytes}
    print(f"[parallel] (b) ZeRO-1 at one rank: losses within {rel:.3g} of the plain trainer's; "
          f"{timed['zero']:.3f} device ms/step; optimizer state {zero_bytes} bytes on the rank "
          f"(plain {plain_bytes})", flush=True)

    # (c) a directory checkpoint, read back by a fresh mesh trainer
    tr = trainers["mesh"]
    tr.config.checkpoint_backend = "orbax"
    path = tr.save(TRAIN_EPOCHS, 0.0)
    back = Trainer(config(checkpoint_backend="orbax"), ResNet18(10), loader(trainset),
                   testloader, tree=tree, mesh=mesh)
    back.load(path)
    saved, read = tr.model.state_dict(), back.model.state_dict()
    check(Path(path).is_dir() and all(torch.equal(saved[k], read[k]) for k in saved),
          f"(c) {path} read back unequal")
    again = [tr.train_epoch(TRAIN_EPOCHS)["step_losses"][0],
             back.train_epoch(TRAIN_EPOCHS)["step_losses"][0]]
    check(abs(again[0] - again[1]) <= PAR_RTOL * abs(again[0]),
          f"(c) next step's loss {again[1]} after the load, {again[0]} in the saver")
    files = sorted(f.name for f in Path(path).iterdir())
    out["c"] = {"path": Path(path).name, "files": files,
                "bytes": sum(f.stat().st_size for f in Path(path).iterdir()),
                "next_loss": again}
    print(f"[parallel] (c) {Path(path).name}: {files}, {out['c']['bytes']} bytes, state dict "
          f"read back bitwise; next step's loss {again[1]!r} against the saver's "
          f"{again[0]!r}", flush=True)
    del back, trainers

    # (d) two ranks on the one card over gloo, against the plain trainer: one
    # global step (running statistics gated), then PAR_STEPS
    steps = (1, PAR_STEPS)
    refs = {}
    with deterministic_cudnn():
        for n in steps:
            ref = Trainer(config(), init,
                          loader(LearnableSyntheticDataset(10, size=n * TRAIN_BATCH, seed=0)),
                          testloader, tree=tree)
            refs[n] = (ref.train_epoch(0)["step_losses"],
                       {k: v.cpu() for k, v in ref.model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))})
    del ref
    (workdir / "args.json").write_text(json.dumps(
        {"steps": steps, "batch": TRAIN_BATCH, "serve_batch": BATCH, "seed": 61}))
    t0 = time.perf_counter()
    r0, r1 = launch_pair(workdir)
    pair_s = time.perf_counter() - t0
    rels, stats = {}, {}
    for n in steps:
        check(r0[f"losses{n}"] == r1[f"losses{n}"],
              f"(d) rank losses {r0[f'losses{n}']} vs {r1[f'losses{n}']}")
        rels[n] = loss_gate(f"(d) two ranks vs plain, {n} steps",
                            [float(v) for v in r0[f"losses{n}"]], refs[n][0])
        diffs = []  # (largest difference, the statistic's largest magnitude, key, rank)
        for r in range(2):
            got = torch.load(workdir / f"state{n}_{r}.pth", weights_only=True)
            diffs += [(float((got[k] - w).abs().max()), float(w.abs().max()), k, r)
                      for k, w in refs[n][1].items()]
        stats[n] = max(diffs)
    check(stats[1][0] <= PAR_STATS_TOL,
          f"(d) running statistics after one step differ by up to {stats[1]}")
    stats_err = stats[1][0]
    serving = [r["serving"] for r in (r0, r1)]
    for sv in serving:
        check(sv["shape"] == [BATCH, 10] and sv["agreement"] == 1.0,
              f"(d) shard_serving: {sv}")
    last = r0[f"losses{PAR_STEPS}"]
    out["d"] = {"backend": r0["backend"], "steps": PAR_STEPS, "losses": last,
                "max_rel_loss_diff": max(rels.values()),
                "running_stat_diff_after_1_step": stats_err,
                f"running_stat_diff_after_{PAR_STEPS}_steps": stats[PAR_STEPS][0],
                "device_ms_per_step": [r0["ms_per_step"], r1["ms_per_step"]],
                "serving": serving, "seconds": pair_s}
    print(f"[parallel] (d) two ranks on one card over {r0['backend']} (devices "
          f"{r0['device']}, {r1['device']}), {TRAIN_BATCH // 2} rows each: losses bit-identical "
          f"on both ({', '.join(last)}), within {max(rels.values()):.3g} of the plain "
          f"trainer's; running statistics after one step within {stats_err:.3g} (tolerance "
          f"{PAR_STATS_TOL}), after {PAR_STEPS} {stats[PAR_STEPS][0]:.3g} ({stats[PAR_STEPS][2]}, "
          f"largest |value| {stats[PAR_STEPS][1]:.3g}; not gated, see PAR_STATS_TOL); "
          f"{r0['ms_per_step']:.3f} and "
          f"{r1['ms_per_step']:.3f} device ms/step (gloo through the host: no measure of "
          f"NCCL)", flush=True)
    print(f"[parallel] (d) shard_serving of the flagship fn (bf16 + fold_bn + uint8) at "
          f"{BATCH}: argmax agreement {serving[0]['agreement']} on "
          f"{serving[0]['rows_decided']} decided rows, largest leaf difference "
          f"{serving[0]['max_leaf_diff']:.3g}; {serving[0]['host_ms_per_request']:.3f} host ms "
          f"a request; the pair took {pair_s:.1f} s", flush=True)

    # (e) --profile: 3 steps of (a) under the trace
    small = LearnableSyntheticDataset(10, size=PAR_PROFILE_STEPS * TRAIN_BATCH, seed=0)
    prof = Trainer(config(), init, loader(small), testloader, tree=tree, mesh=mesh)
    with trace(str(workdir / "trace")):
        prof.train_epoch(0)
        torch.cuda.synchronize()
    kernels, events, nbytes = trace_kernel_events(workdir / "trace")
    check(kernels > 0, f"(e) the trace holds no CUDA kernel event ({events} events)")
    out["e"] = {"steps": PAR_PROFILE_STEPS, "kernel_events": kernels, "events": events,
                "bytes": nbytes}
    print(f"[parallel] (e) trace of {PAR_PROFILE_STEPS} mesh steps: {events} events, "
          f"{kernels} CUDA kernel events, {nbytes} bytes", flush=True)
    del prof, tr

    # (f) the CLI
    t0 = time.perf_counter()
    acc, text = run_cli(["--mesh", "--zero", "--synthetic", "--cache-dataset", "--dataset",
                         "CIFAR10", "--arch", "ResNet18", "--loss", "SoftTreeSupLoss",
                         "--epochs", "1", "--batch-size", str(TRAIN_BATCH), "--no-progress",
                         "--checkpoint-backend", "orbax", "--checkpoint-dir",
                         str(workdir / "cli")])
    dcp = sorted(p.name for p in (workdir / "cli").glob("*.dcp") if p.is_dir())
    check(0 <= acc <= 100 and "==> Best accuracy" in text and dcp,
          f"(f) CLI: accuracy {acc}, directories {dcp}")
    out["f"] = {"test_acc": acc, "dcp": dcp, "seconds": time.perf_counter() - t0}
    print(f"[parallel] (f) python -m nbdt_torch.main --mesh --zero --cache-dataset "
          f"--checkpoint-backend orbax ...: test accuracy {acc:.2f}%, {dcp}, "
          f"{out['f']['seconds']:.1f} s", flush=True)

    torch.cuda.synchronize()
    out["launches"] = read_launches()
    print(f"[parallel] kernel launches over the parallel path: {json.dumps(out['launches'])}",
          flush=True)
    check(out["launches"] == {"soft_head": 0, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"parallel path launches {out['launches']}")
    dist.destroy_process_group()
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def hard_mismatches(got: torch.Tensor, want: torch.Tensor, rows: torch.Tensor, jt,
                    tie: float) -> tuple:
    """(pixels whose hard one-hot differs, those among them where some node's
    two best children are within ``tie`` on the reference's class-map
    ``rows``: the only pixels where an error of the node logits that small
    can flip the walk)."""
    bad = (got != want).any(-1)
    if not bool(bad.any()):
        return 0, 0
    nl = get_all_node_outputs(rows[bad].float(), jt).logits
    top2 = torch.where(jt.child_mask[None], nl, -torch.inf).topk(2, dim=-1).values
    ties = ((top2[..., 0] - top2[..., 1]) <= tie).any(-1)
    return int(bad.sum()), int(ties.sum())


def serve_seg(dataset: str, hierarchy: str, batch: int, h: int, w: int, seed: int) -> dict:
    """One seg serving cell: SoftSegNBDT and HardSegNBDT over a seeded SegNet
    on the vendored tree, a request of batch x h x w pixels; the gates of
    the SEG_* comment, device ms a request, Mpixels/s and peak memory."""
    tree = Tree(dataset, hierarchy=hierarchy)
    C, jt = tree.arrays.num_classes, to_device_tree(tree.arrays, "cuda")
    torch.manual_seed(seed)
    model = SegNet(C).to("cuda", memory_format=torch.channels_last)
    cgen = torch.Generator(device="cuda").manual_seed(seed)
    x = imagenet_normalize(imagenet_images(batch, h, cgen, width=w))
    calibrate_batchnorm(model, x)
    soft, hard = SoftSegNBDT(None, model, tree=tree), HardSegNBDT(None, model, tree=tree)
    P, outs, peak = batch * h * w, {}, {}
    torch.cuda.synchronize()
    reset_launches()
    for name, wrapper in (("soft", soft), ("hard", hard)):
        torch.cuda.reset_peak_memory_stats()
        outs[name] = wrapper(x)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated()
    launches = read_launches()
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"[seg] {dataset} launched kernels: {launches}")
    s, hd = outs["soft"], outs["hard"]
    check(s.shape == hd.shape == (batch, h, w, C) and bool(torch.isfinite(s).all()),
          f"[seg] {dataset}: outputs {tuple(s.shape)}, {tuple(hd.shape)}")
    flat_hard = hd.reshape(-1, C)
    check(bool(((flat_hard == 0) | (flat_hard == 1)).all() and (flat_hard.sum(1) == 1).all()),
          f"[seg] {dataset}: hard outputs are not one-hot")

    # the wrappers against the rules on the same class-map rows
    with torch.no_grad():
        maps = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).reshape(-1, C)
    idx = torch.randperm(P, device="cuda", generator=cgen)[:SEG_SAMPLE]
    rows = maps[idx]
    soft_err = float((s.reshape(-1, C)[idx] - SoftEmbeddedDecisionRules(tree=tree)(rows))
                     .abs().max())
    check(soft_err <= SEG_TOL, f"[seg] {dataset}: soft leaves off the rules by {soft_err}")
    bad, ties = hard_mismatches(flat_hard[idx], HardEmbeddedDecisionRules(tree=tree)(rows), rows,
                                jt, SEG_TIE)
    check(bad == ties, f"[seg] {dataset}: {bad} sampled pixels' hard leaves differ from the "
                       f"rules', {ties} of them at ties")
    classes_predicted = int(flat_hard.argmax(1).unique().numel())
    del maps, rows, outs, s, hd, flat_hard

    # the card against device="cpu" on a crop of the request
    n, ch, cw = SEG_XDEV
    xs = x[:n, :ch, :cw].contiguous()
    cpu_model = copy.deepcopy(model)
    cpu_soft = SoftSegNBDT(None, cpu_model, tree=tree, device="cpu")
    cpu_hard = HardSegNBDT(None, cpu_model, tree=tree, device="cpu")
    with torch.no_grad():
        map_gpu = model(xs.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).reshape(-1, C).cpu()
        map_cpu = cpu_model(xs.cpu().permute(0, 3, 1, 2)).permute(0, 2, 3, 1).reshape(-1, C)
    map_diff = float((map_gpu - map_cpu).abs().max())
    xdev_soft = float((soft(xs).cpu() - cpu_soft(xs.cpu())).abs().max())
    check(xdev_soft <= SEG_TOL, f"[seg] {dataset}: soft card vs CPU {xdev_soft}")
    xbad, xties = hard_mismatches(hard(xs).cpu().reshape(-1, C),
                                  cpu_hard(xs.cpu()).reshape(-1, C),
                                  map_cpu, to_device_tree(tree.arrays, "cpu"),
                                  2 * map_diff + 1e-6)
    check(xbad == xties, f"[seg] {dataset}: {xbad} pixels' hard leaves differ card vs CPU, "
                         f"{xties} of them at ties")

    if dataset == "ADE20K":
        print_profile(f"SoftSegNBDT {dataset} request of {batch}x{h}x{w}",
                      *profile_ms(lambda: soft(x), n=2))
    rec = {"dataset": dataset, "hierarchy": hierarchy, "classes": C,
           "inner_nodes": tree.arrays.num_inodes, "batch": batch, "height": h, "width": w,
           "pixels": P, "launches": launches, "soft_max_abs_err": soft_err,
           "hard_mismatches": bad, "hard_ties": ties, "classes_predicted": classes_predicted,
           "xdev_crop": list(SEG_XDEV), "xdev_soft_max_abs_err": xdev_soft,
           "xdev_class_map_max_abs_diff": map_diff, "xdev_hard_mismatches": xbad,
           "xdev_hard_ties": xties}
    for name, wrapper in (("soft", soft), ("hard", hard)):
        ms = time_cuda(lambda: wrapper(x), n=SEG_TIMED, warmup=1)
        rec.update({f"{name}_ms_per_request": ms,
                    f"{name}_wall_ms_per_request": wall_ms(lambda: wrapper(x), n=SEG_TIMED,
                                                           warmup=1),
                    f"{name}_mpixels_per_s": P / ms / 1e3,
                    f"{name}_peak_bytes": peak[name]})
    print(f"[seg] {dataset} {hierarchy} (C={C}) request of {batch}x{h}x{w} = {P} pixels: "
          f"SoftSegNBDT {rec['soft_ms_per_request']:.3f} ms ({rec['soft_mpixels_per_s']:.1f} "
          f"Mpixels/s, host clock {rec['soft_wall_ms_per_request']:.3f} ms, peak "
          f"{peak['soft'] / 1e9:.3f} GB), HardSegNBDT {rec['hard_ms_per_request']:.3f} ms "
          f"({rec['hard_mpixels_per_s']:.1f} Mpixels/s, peak {peak['hard'] / 1e9:.3f} GB); "
          f"{SEG_SAMPLE} sampled pixels: soft within {soft_err:.3g} of the rules, hard "
          f"{bad} differing ({ties} at ties); card vs CPU on {n}x{ch}x{cw}: soft {xdev_soft:.3g}, "
          f"hard {xbad} differing ({xties} at ties; class maps within {map_diff:.3g}); "
          f"{classes_predicted} classes predicted; launches {json.dumps(launches)}", flush=True)
    return rec


def check_seg_tree_precision(model, x: torch.Tensor, y: torch.Tensor, jt) -> int:
    """The seg trainer's loss under a process-wide "medium" f32 precision:
    every product touching the tree's N*K slots runs at "highest", forward
    and backward (node logits and leaf sums: two products each way)."""
    S = jt.num_inodes * jt.max_children
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        spy = PrecisionSpy()
        with spy:
            out = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            train_seg.seg_loss(out, y, jt, 1.0).backward()
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(prev)
        model.zero_grad(set_to_none=True)
    tree = [prec for shapes, prec in spy.calls if any(S in shape for shape in shapes)]
    check(len(tree) == 4 and set(tree) == {"highest"},
          f"[seg train] tree-loss products and their precisions: {tree}")
    return len(tree)


def run_seg_training() -> dict:
    """The seg trainer at PascalContext's shape: the loader's host ms a
    batch, the first step card vs CPU, 2 epochs of 8 steps through
    ``train_seg.fit`` on the card, a step's device ms on a fixed batch, the
    tree products' precision, then the CLI at its defaults."""
    lr, tsw = 0.05, 1.0

    def dataset(seed=0, size=SEG_BATCH * SEG_STEPS):
        return SyntheticSegDataset(num_classes=SEG_CLASSES, size=size, image_size=SEG_IMAGE,
                                   crop_size=SEG_CROP, seed=seed)

    t0 = time.perf_counter()
    batches = list(SegDataLoader(dataset(), SEG_BATCH, shuffle=True))
    loader_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    x0, y0 = batches[0]
    torch.manual_seed(13)
    init = SegNet(SEG_CLASSES)
    tree = train_seg.induce_tree(init, [f"segclass{i}" for i in range(SEG_CLASSES)])
    first = {}
    for key, dev in (("card", "cuda"), ("cpu", "cpu")):
        model = copy.deepcopy(init).to(dev, memory_format=torch.channels_last)
        step = train_seg.make_seg_step(
            model, torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9),
            to_device_tree(tree.arrays, dev), tsw)
        first[key] = float(step(torch.as_tensor(x0, device=dev), torch.as_tensor(y0, device=dev)))
    diff = abs(first["card"] - first["cpu"])
    check(diff <= SEG_LOSS_TOL, f"[seg train] first step card vs CPU: {first}")

    val = dataset(seed=1, size=SEG_BATCH)
    val.split = "val"
    model = copy.deepcopy(init).to("cuda", memory_format=torch.channels_last)
    jt = to_device_tree(tree.arrays, "cuda")
    t0 = time.perf_counter()
    records = train_seg.fit(model, jt, SegDataLoader(dataset(), SEG_BATCH, shuffle=True),
                            SegDataLoader(val, SEG_BATCH, drop_last=False), 2, lr, tsw, "cuda",
                            log=lambda line: print(f"[seg train] {line}", flush=True))
    fit_s = time.perf_counter() - t0
    losses = [v for r in records for v in r["step_losses"]]
    check(len(losses) == 2 * SEG_STEPS and all(math.isfinite(v) for v in losses),
          f"[seg train] step losses {losses}")
    xb, yb = torch.as_tensor(x0, device="cuda"), torch.as_tensor(y0, device="cuda")
    step = train_seg.make_seg_step(model, torch.optim.SGD(model.parameters(), lr=lr,
                                                          momentum=0.9), jt, tsw)
    step_ms = time_cuda(lambda: step(xb, yb), n=SEG_TIMED, warmup=2)
    print_profile(f"SegNet train step, batch {SEG_BATCH}, {SEG_CROP}px, {SEG_CLASSES} classes",
                  *profile_ms(lambda: step(xb, yb), n=3))
    n_products = check_seg_tree_precision(model, xb, yb, jt)

    t0 = time.perf_counter()
    cli = train_seg.main(["--dataset", "synthetic", "--epochs", "1"])
    cli_losses = cli["epochs"][0]["step_losses"]
    check(len(cli_losses) == 8 and all(math.isfinite(v) for v in cli_losses)
          and cli["output_shape"] == (8, 64, 64, 20), f"[seg train] the CLI: {cli}")
    cli_s = time.perf_counter() - t0
    print(f"[seg train] PascalContext shape ({SEG_CLASSES} classes, {SEG_IMAGE}px cropped to "
          f"{SEG_CROP}, batch {SEG_BATCH}): SegDataLoader {loader_ms:.1f} host ms a batch; "
          f"a step {step_ms:.3f} device ms on a fixed batch; 2 epochs of {SEG_STEPS} steps "
          f"through fit in {fit_s:.2f} s ({fit_s * 1e3 / (2 * SEG_STEPS):.1f} ms a step with "
          f"the loader and the eval), losses {[round(v, 4) for v in losses]}; first step card "
          f"{first['card']:.7f} vs CPU {first['cpu']:.7f} (|diff| {diff:.3g}, tolerance "
          f"{SEG_LOSS_TOL}); tree-loss products at \"highest\": {n_products}; the CLI "
          f"(--dataset synthetic --epochs 1) in {cli_s:.1f} s, loss "
          f"{cli['epochs'][0]['loss']:.4f}", flush=True)
    return {"classes": SEG_CLASSES, "image": SEG_IMAGE, "crop": SEG_CROP, "batch": SEG_BATCH,
            "steps_per_epoch": SEG_STEPS, "loader_host_ms_per_batch": loader_ms,
            "device_ms_per_step": step_ms, "fit_seconds": fit_s,
            "fit_ms_per_step": fit_s * 1e3 / (2 * SEG_STEPS), "step_losses": losses,
            "pixel_acc": [r["pixel_acc"] for r in records], "first_step_card": first["card"],
            "first_step_cpu": first["cpu"], "first_step_abs_diff": diff,
            "tree_products_highest": n_products,
            "cli": {"loss": cli["epochs"][0]["loss"], "seconds": cli_s}}


def run_seg_path() -> dict:
    """(a) seg serving at 2,097,152 pixels a request on two trees, (b) the
    seg trainer; no kernel launches over either."""
    torch.cuda.synchronize()
    reset_launches()
    serving = {f"{d.lower()}_{b}x{h}x{w}": serve_seg(d, hier, b, h, w, 300 + i)
               for i, (d, hier, b, h, w) in enumerate(SEG_SERVE)}
    training = run_seg_training()
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"segmentation path launched kernels: {launches}")
    print(f"[seg] kernel launches over the segmentation path: {json.dumps(launches)}",
          flush=True)
    return {"serving": serving, "train": training, "launches": launches}


def run_native_phase(train: dict) -> dict:
    """The host kernels against numpy at the training path's batch (512 x
    32x32x3): gather bitwise, augment and normalize within NATIVE_TOL; their
    host ms against the numpy path's; the training path's host-fed run went
    through the native gather and augment."""
    check(native.available(), f"[native] no library: {native.build_error}")
    rng = np.random.RandomState(21)
    store = rng.randint(0, 256, (TRAIN_SIZE, 32, 32, 3), dtype=np.uint8)
    idx = rng.permutation(TRAIN_SIZE)[:TRAIN_BATCH]
    x = store[idx]
    gathered = native.gather_batch_u8(store, idx)
    check(np.array_equal(gathered, x), "[native] gather_batch_u8 differs from numpy indexing")

    def numpy_augment(r):  # the numpy path of make_train_transform, its draws included
        ys, xs = r.randint(0, 9, size=len(x)), r.randint(0, 9, size=len(x))
        return normalize(augment_uint8(x, 4, ys, xs, r.rand(len(x)) < 0.5), CIFAR_MEAN, CIFAR_STD)

    aug_err = float(np.abs(native.augment_batch(x, 4, CIFAR_MEAN, CIFAR_STD,
                                                np.random.RandomState(5))
                           - numpy_augment(np.random.RandomState(5))).max())
    norm_err = float(np.abs(native.normalize_batch(x, CIFAR_MEAN, CIFAR_STD)
                            - normalize(x, CIFAR_MEAN, CIFAR_STD)).max())
    check(aug_err <= NATIVE_TOL and norm_err <= NATIVE_TOL,
          f"[native] augment {aug_err}, normalize {norm_err} off numpy")

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(NATIVE_TIMED):
            fn()
        return (time.perf_counter() - t0) * 1e3 / NATIVE_TIMED

    r = np.random.RandomState(6)
    times = {
        "gather_native": host_ms(lambda: native.gather_batch_u8(store, idx)),
        "gather_numpy": host_ms(lambda: store[idx]),
        "augment_native": host_ms(lambda: native.augment_batch(x, 4, CIFAR_MEAN, CIFAR_STD, r)),
        "augment_numpy": host_ms(lambda: numpy_augment(r)),
        "normalize_native": host_ms(lambda: native.normalize_batch(x, CIFAR_MEAN, CIFAR_STD)),
        "normalize_numpy": host_ms(lambda: normalize(x, CIFAR_MEAN, CIFAR_STD)),
    }
    host_fed = train["hard_host_fed"]
    calls = host_fed["native_calls"]
    check(calls["gather_batch_u8"] > 0 and calls["augment_batch"] > 0,
          f"[native] the host-fed training run did not go through the library: {calls}")
    step = host_fed["epochs"][1]
    print(f"[native] {native.library_path().name} built and loaded; at {TRAIN_BATCH}x32x32x3: "
          f"gather bitwise equal to numpy, augment within {aug_err:.3g}, normalize within "
          f"{norm_err:.3g}; host ms a batch, native vs numpy: "
          + ", ".join(f"{k} {times[f'{k}_native']:.3f} vs {times[f'{k}_numpy']:.3f}"
                      for k in ("gather", "augment", "normalize"))
          + f"; the host-fed ResNet18 run's native calls {json.dumps(calls)}, its epoch-1 step "
          f"{step['device_ms_per_step']:.3f} device ms ({step['host_ms_per_step']:.3f} host ms; "
          f"on the numpy path: {NUMPY_HOST_FED_MS} device ms)", flush=True)
    return {"library": native.library_path().name, "batch": [TRAIN_BATCH, 32, 32, 3],
            "augment_max_abs_err": aug_err, "normalize_max_abs_err": norm_err,
            "gather_bitwise": True, "host_ms_per_batch": times, "host_fed_native_calls": calls,
            "host_fed_device_ms_per_step": step["device_ms_per_step"],
            "host_fed_host_ms_per_step": step["host_ms_per_step"]}


class StepRecorder:
    """Wraps ``train_imagenet.make_train_step`` while active: each step's
    CUDA events, host ms (the call's own: its launches, not their
    completion), its start on the host clock (successive starts bound the
    loop's period, the loader's batch and its copy to the card included)
    and, once, the model's state after the first step."""

    def __init__(self):
        self.events, self.host_ms, self.starts, self.first_state = [], [], [], None

    @contextlib.contextmanager
    def active(self):
        original = train_imagenet.make_train_step

        def make(model, *args, **kw):
            step = original(model, *args, **kw)

            def recorded(*a):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                self.starts.append(t0)
                start.record()
                m = step(*a)
                end.record()
                self.host_ms.append((time.perf_counter() - t0) * 1e3)
                self.events.append((start, end))
                if self.first_state is None:
                    self.first_state = {k: v.detach().cpu().clone()
                                        for k, v in model.state_dict().items()}
                return m

            return recorded

        train_imagenet.make_train_step = make
        try:
            yield self
        finally:
            train_imagenet.make_train_step = original

    def device_ms(self, last: int) -> float:
        """Mean device ms of the last ``last`` steps but the run's first (its
        cuDNN and allocator set-up)."""
        torch.cuda.synchronize()
        events = self.events[max(1, len(self.events) - last):]
        return float(np.mean([a.elapsed_time(b) for a, b in events]))

    def period_ms(self, last: int) -> float:
        """Host ms from one step's start to the next, over the last ``last``
        steps (one epoch: no eval between them)."""
        return float(np.mean(np.diff(self.starts[-last:]))) * 1e3


def imagenet_main(argv: list, recorder: StepRecorder) -> tuple:
    """``train_imagenet.main(argv)`` in this process, echoed: (its return
    value, its standard output)."""
    buf = io.StringIO()
    try:
        with recorder.active(), contextlib.redirect_stdout(buf):
            out = train_imagenet.main(argv)
    finally:
        sys.stdout.write(buf.getvalue())
        sys.stdout.flush()
    return out, buf.getvalue()


def imagenet_train_config(name: str, epochs: int) -> dict:
    """One config through ``train_imagenet.main`` on the card: its epoch
    lines, every step's loss finite, each step's learning rate the
    schedule's, device ms a step (CUDA events, the last epoch's steps but
    the run's first), host ms a step, images/s and peak device bytes."""
    config = IMT_CONFIGS / f"{name}-nbdt.json"
    cfg = json.loads(config.read_text())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = StepRecorder()
    out, text = imagenet_main(["--config", str(config), "--synthetic", "--epochs",
                               str(epochs)], rec)
    steps_per_epoch = len(out["step_losses"]) // epochs
    check(len(out["step_losses"]) == 2 * epochs
          and all(math.isfinite(v) for v in out["step_losses"]),
          f"[imagenet train] {name}: step losses {out['step_losses']}")
    lr_at = train_imagenet.build_lr_schedule(cfg["optimizer"], steps_per_epoch, epochs)
    want = [lr_at(i) for i in range(len(out["lrs"]))]
    check(out["lrs"] == want, f"[imagenet train] {name}: learning rates {out['lrs']} against "
                              f"the schedule's {want}")
    lines = re.findall(r"epoch \d+: loss=.*", text)
    check(len(lines) == epochs, f"[imagenet train] {name}: epoch lines {lines}")
    device_ms = rec.device_ms(steps_per_epoch)
    batch = cfg["batch_size"]
    res = {"arch": cfg["model"]["arch"], "batch": batch, "image": cfg["model"]["image_size"],
           "classes": cfg["model"]["num_classes"], "epochs": epochs,
           "step_losses": out["step_losses"], "lrs": out["lrs"], "epoch_lines": lines,
           "device_ms_per_step": device_ms,
           "host_ms_per_step": float(np.mean(rec.host_ms[max(1, len(rec.host_ms)
                                                             - steps_per_epoch):])),
           "loop_ms_per_step": rec.period_ms(steps_per_epoch),
           "images_per_s": batch / device_ms * 1e3,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "tree": Path(out["tree"].path_graph).name}
    print(f"[imagenet train] {name}: {res['arch']} at {res['image']}px, {res['classes']} "
          f"classes, batch {batch}, tree {res['tree']}: {res['device_ms_per_step']:.3f} device "
          f"ms/step, {res['host_ms_per_step']:.3f} host ms/step (the step's launches), "
          f"{res['loop_ms_per_step']:.3f} ms from one step's start to the next (the batch's "
          f"copy to the card included), {res['images_per_s']:.1f} images/s on device time, "
          f"peak {res['peak_device_bytes']} device bytes; learning rates {out['lrs']} = the "
          f"schedule's", flush=True)
    return res, out


def run_imagenet_training(workdir: Path) -> dict:
    """The ImageNet training path (``python -m nbdt_torch.examples.train_imagenet``,
    ROADMAP A13b): the resnet18 config at its published width for
    IMT_EPOCHS epochs, the resnet50 config for 1; the first step card vs
    CPU; the tree products at "highest"; the efficientnet_b7b config's
    schedule (not trained here: its f32 activations at batch 128 and 224px
    come near the card's 80 GB). No kernel launches. Then the tp pair."""
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    out = {}
    torch.cuda.synchronize()
    reset_launches()
    out["resnet18"], r18 = imagenet_train_config("resnet18", IMT_EPOCHS)
    out["resnet50"], _ = imagenet_train_config("resnet50", 1)
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    print(f"[imagenet train] kernel launches over the two configs' runs: "
          f"{json.dumps(out['launches'])}", flush=True)
    check(out["launches"] == {"soft_head": 0, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"imagenet training path launches {out['launches']}")

    # the tree products of the trained resnet18, forward and backward
    model, tree = r18["model"], r18["tree"]
    jt = to_device_tree(tree.arrays, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(71)
    x = torch.randint(0, 256, (8, 224, 224, 3), generator=gen, device="cuda").float()
    y = torch.randint(0, 1000, (8,), generator=gen, device="cuda")
    out["tree_products_at_highest"] = check_tree_matmul_precision(model, x, y, jt)
    print(f"[imagenet train] the {out['tree_products_at_highest']} tree-loss products on the "
          f"1000-class tree ran at \"highest\" under a caller's \"medium\"", flush=True)
    # where a step's device time goes: the example's step at rate 0 (the
    # weights stay), on a batch already on the card
    step = train_imagenet.make_train_step(
        model, torch.optim.SGD(model.parameters(), lr=0.0, momentum=0.9, weight_decay=1e-4),
        lambda count: 0.0, "SoftTreeSupLoss", jt, tsw=5.0)
    xb = torch.randint(0, 256, (256, 224, 224, 3), generator=gen, device="cuda").float()
    yb = torch.randint(0, 1000, (256,), generator=gen, device="cuda")
    print_profile("resnet18 config step (batch 256, 224px, f32, the batch on the card)",
                  *profile_ms(lambda: step(xb, yb, 5.0, 1.0, 0), n=3))
    del model, r18, step, xb

    # the first step, card vs CPU
    config = str(IMT_CONFIGS / "resnet18-nbdt.json")
    first = {}
    for dev in ("cuda", "cpu"):
        rec = StepRecorder()
        t0 = time.perf_counter()
        with rec.active(), contextlib.redirect_stdout(io.StringIO()):
            run = train_imagenet.main(["--config", config, "--synthetic", "--epochs", "1",
                                       "--batch-size", str(IMT_XSTEP_BATCH), "--device", dev])
        first[dev] = (run["step_losses"][0], rec.first_state, time.perf_counter() - t0)
    rel = abs(first["cuda"][0] - first["cpu"][0]) / abs(first["cpu"][0])
    init = train_imagenet.init_model("resnet18", 1000, (224, 224, 3), device="cpu").state_dict()
    params = [k for k, _ in init.items() if not k.endswith(("running_mean", "running_var",
                                                            "num_batches_tracked"))]
    cuda, cpu = first["cuda"][1], first["cpu"][1]
    update_err = (sum(float(((cuda[k] - cpu[k]) ** 2).sum()) for k in params)
                  / sum(float(((cpu[k] - init[k]) ** 2).sum()) for k in params)) ** 0.5
    worst = max((float((cuda[k] - cpu[k]).abs().max())
                 / max(float((cpu[k] - init[k]).abs().max()), 1e-30),
                 k) for k in params)
    check(rel <= IMT_RTOL, f"[imagenet train] card vs CPU first step: loss "
                           f"{first['cuda'][0]} vs {first['cpu'][0]}")
    check(update_err <= IMT_STATE_TOL, f"[imagenet train] card vs CPU update of the first step: "
                                       f"{update_err} (worst tensor {worst})")
    out["card_vs_cpu"] = {"batch": IMT_XSTEP_BATCH, "loss_cuda": first["cuda"][0],
                          "loss_cpu": first["cpu"][0], "relative": rel,
                          "update_rel_l2": update_err, "worst_tensor": worst,
                          "cpu_seconds": first["cpu"][2]}
    print(f"[imagenet train] first step of the resnet18 config at batch {IMT_XSTEP_BATCH}, card "
          f"vs CPU: loss {first['cuda'][0]:.7f} vs {first['cpu'][0]:.7f} (relative {rel:.3g}, "
          f"tolerance {IMT_RTOL}); the step's update (L2 over the parameters) {update_err:.3g} "
          f"apart (tolerance {IMT_STATE_TOL}; worst tensor {worst[1]}, its largest entry "
          f"difference {worst[0]:.3g} of its largest update); the CPU run took "
          f"{first['cpu'][2]:.1f} s", flush=True)

    # the efficientnet_b7b config: parsed, its schedule checked, not trained
    cfg = json.loads((IMT_CONFIGS / "efficientnet_b7b-nbdt.json").read_text())
    lr_cfg = cfg["optimizer"]["lr"]
    lr_at = train_imagenet.build_lr_schedule(cfg["optimizer"], 5005, cfg["num_epochs"])
    warmup = int(5005 * cfg["num_epochs"] * lr_cfg["warmup_frac"])
    for i, m in enumerate(lr_cfg["milestones"]):
        got = [lr_at(m * 5005 + d) for d in (-1, 0, 1)]
        check(np.allclose(got, [lr_cfg["values"][i]] + [lr_cfg["values"][i + 1]] * 2,
                          rtol=1e-9), f"[imagenet train] b7b schedule at epoch {m}: {got}")
    check(np.allclose([lr_at(0), lr_at(warmup)], [lr_cfg["start_value"], lr_cfg["values"][0]],
                      rtol=1e-9), f"[imagenet train] b7b warmup: {lr_at(0)}, {lr_at(warmup)}")
    out["efficientnet_b7b"] = {"arch": cfg["model"]["arch"], "batch": cfg["batch_size"],
                               "warmup_steps": warmup, "trained": False}
    print(f"[imagenet train] efficientnet_b7b config: {cfg['model']['arch']} at batch "
          f"{cfg['batch_size']}, {warmup} warmup steps of 5005x{cfg['num_epochs']}, decays at "
          f"epochs {lr_cfg['milestones']} on their first steps; not trained here", flush=True)

    out["tp"] = run_tp_pair(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


TP_WORKER = r"""
import faulthandler, json, sys, time
from pathlib import Path
workdir, rank = Path(sys.argv[1]).resolve(), int(sys.argv[2])
args = json.loads((workdir / "args.json").read_text())
faulthandler.dump_traceback_later(args["deadline"] - 20, exit=True)  # every thread's stack
import torch
import torch.distributed as dist
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True  # a comparison
from nbdt_torch.examples import train_imagenet
from nbdt_torch.parallel import initialize_multihost

store = f"file://{workdir / 'store'}"
initialize_multihost(store, 2, rank, backend="gloo")  # NCCL refuses two ranks on one card
events = []
original = train_imagenet.make_train_step


def make(*a, **kw):
    step = original(*a, **kw)

    def timed(*s):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(*s)
        end.record()
        events.append((start, end))
        return m

    return timed


train_imagenet.make_train_step = make
run = train_imagenet.main(["--config", args["config"], "--synthetic", "--epochs",
                           str(args["epochs"]), "--tp", "2", "--multihost",
                           "--coordinator-address", store, "--num-processes", "2",
                           "--process-id", str(rank)])
torch.cuda.synchronize()
head = run["model"].fc
out = {"backend": dist.get_backend(), "device": torch.cuda.current_device(),
       "mesh": list(run["mesh"]), "losses": ["%.17g" % v for v in run["step_losses"]],
       "head": type(head).__name__, "shard": list(head.weight.shape),
       "bias": list(head.bias.shape),
       "ms_per_step": [a.elapsed_time(b) for a, b in events]}
(workdir / f"rank{rank}.json").write_text(json.dumps(out))
dist.destroy_process_group()
"""


def run_tp_pair(workdir: Path) -> dict:
    """A13b on the card: two ranks sharing it over gloo run the resnet18
    config at ``--tp 2`` (dp=1, tp=2: 500 classes a rank) for IMT_TP_EPOCHS
    epochs; their losses against a one-rank tp=1 run of the same steps,
    both with cuDNN's deterministic algorithms."""
    config = str(IMT_CONFIGS / "resnet18-nbdt.json")
    with deterministic_cudnn(), contextlib.redirect_stdout(io.StringIO()):
        ref = train_imagenet.main(["--config", config, "--synthetic", "--epochs",
                                   str(IMT_TP_EPOCHS)])["step_losses"]
    torch.cuda.empty_cache()
    (workdir / "args.json").write_text(json.dumps({"config": config, "epochs": IMT_TP_EPOCHS,
                                                   "deadline": IMT_DEADLINE}))
    t0 = time.perf_counter()
    r0, r1 = launch_pair(workdir, TP_WORKER, IMT_DEADLINE)
    pair_s = time.perf_counter() - t0
    check(r0["losses"] == r1["losses"], f"[tp] rank losses {r0['losses']} vs {r1['losses']}")
    got = [float(v) for v in r0["losses"]]
    check(len(got) == len(ref), f"[tp] {len(got)} steps against {len(ref)}")
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, ref))
    check(rel <= IMT_RTOL, f"[tp] tp=2 losses {got} against one rank's {ref}")
    for r in (r0, r1):
        check(r["mesh"] == [1, 2] and r["head"] == "ColumnShardedLinear"
              and r["shard"] == [500, 512] and r["bias"] == [1000],
              f"[tp] rank's mesh and classifier: {r}")
    ms = [r["ms_per_step"][-1] for r in (r0, r1)]  # the second step: the first sets up cuDNN
    out = {"backend": r0["backend"], "mesh": r0["mesh"], "shard": r0["shard"],
           "losses": got, "one_rank_losses": ref, "max_rel_loss_diff": rel,
           "device_ms_per_step": ms, "seconds": pair_s}
    print(f"[tp] two ranks on one card over {r0['backend']} (devices {r0['device']}, "
          f"{r1['device']}), mesh dp=1 tp=2, classifier shard {r0['shard']} on each (bias "
          f"{r0['bias']} whole): losses bit-identical on both ({', '.join(r0['losses'])}), within "
          f"{rel:.3g} of one rank's (tolerance {IMT_RTOL}); {ms[0]:.3f} and {ms[1]:.3f} device "
          f"ms/step (gloo through the host on one card: no measure of NCCL); the pair took "
          f"{pair_s:.1f} s", flush=True)
    return out


def run_convert_and_examples(workdir: Path) -> dict:
    """Host paths on the card's machine: the convert CLI torch -> msgpack ->
    torch on a seeded resnet18, bit for bit, with neither flax nor msgpack
    installed; ``load_pretrained`` on a seeded checkpoint and PNG on the
    card (and on the CPU); the HTTP app on a free port of localhost, one
    POST of that PNG; ``vis_demo``'s two pages. In this process, no launch
    but ``load_pretrained``'s one f32 ResNet18 forward on the card (17
    bn_act passes)."""
    import importlib.util
    import urllib.request

    from PIL import Image

    from nbdt_torch.models import resnet18
    from nbdt_torch.serialization import read_msgpack

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    torch.cuda.synchronize()
    reset_launches()
    out = {"flax_installed": importlib.util.find_spec("flax") is not None,
           "msgpack_installed": importlib.util.find_spec("msgpack") is not None}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(Path(__file__).resolve().parent), os.environ.get("PYTHONPATH")]))}

    # [convert] torch -> msgpack -> torch
    torch.manual_seed(81)
    model = resnet18(1000)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if b.is_floating_point():
                b.copy_(torch.rand_like(b) + (0.5 if name.endswith("running_var") else -0.5))
    src, mid, back = workdir / "seeded.pth", workdir / "x.msgpack", workdir / "back.pth"
    torch.save({"net": model.state_dict()}, src)
    t0 = time.perf_counter()
    for a, b in ((src, mid), (mid, back)):
        proc = subprocess.run([sys.executable, "-m", "nbdt_torch.models.convert", str(a),
                               "--arch", "resnet18", "--out", str(b)], env=env,
                              capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"[convert] {a.name} -> {b.name}: {proc.stderr[-2000:]}")
    tree = read_msgpack(mid)
    got = torch.load(back, weights_only=True)["net"]
    want = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    check(list(got) == list(want) and all(got[k].dtype == v.dtype and torch.equal(got[k], v)
                                          for k, v in want.items()),
          "[convert] the round trip torch -> msgpack -> torch is not bitwise")
    out["convert"] = {"msgpack_bytes": mid.stat().st_size, "tensors": len(want),
                      "top_keys": list(tree), "seconds": time.perf_counter() - t0}
    print(f"[convert] python -m nbdt_torch.models.convert seeded.pth --arch resnet18 --out "
          f"x.msgpack ({out['convert']['msgpack_bytes']} bytes, {list(tree)}), then back to "
          f".pth: {len(want)} tensors bit for bit; flax installed: {out['flax_installed']}, "
          f"msgpack installed: {out['msgpack_installed']}; "
          f"{out['convert']['seconds']:.1f} s", flush=True)

    # [examples] load_pretrained, the app, vis_demo
    torch.manual_seed(82)
    cifar = ResNet18(10)
    pth, png = workdir / "cifar.pth", workdir / "image.png"
    torch.save({"net": cifar.state_dict()}, pth)
    Image.fromarray(np.random.RandomState(83).randint(0, 256, (32, 32, 3), dtype=np.uint8)).save(
        png)
    argv = [str(png), "--arch", "ResNet18", "--dataset", "CIFAR10", "--checkpoint", str(pth)]
    with contextlib.redirect_stdout(io.StringIO()):
        lines = load_pretrained.main(argv)
        cpu_lines = load_pretrained.main(argv + ["--device", "cpu"])
    check(lines == cpu_lines and lines[0].startswith("Prediction: "),
          f"[examples] load_pretrained on the card {lines}, on the CPU {cpu_lines}")
    out["load_pretrained"] = lines
    print(f"[examples] load_pretrained on the card (equal to the CPU's): {' // '.join(lines)}",
          flush=True)

    proc = subprocess.Popen([sys.executable, "-m", "nbdt_torch.examples.app", "--checkpoint",
                             str(pth), "--arch", "ResNet18", "--port", "0"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        port = re.fullmatch(r"Serving NBDT on :(\d+)\s*", line)
        check(port is not None, f"[examples] the app printed {line!r}")
        t0 = time.perf_counter()
        req = urllib.request.Request(f"http://127.0.0.1:{port.group(1)}/",
                                     data=png.read_bytes(), headers={"Content-Type": "image/png"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            answer = json.loads(resp.read())
        post_ms = (time.perf_counter() - t0) * 1e3
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    check(f"Prediction: {answer.get('prediction')}" == lines[0],
          f"[examples] the app answered {answer}, load_pretrained {lines[0]}")
    out["app"] = {"answer": answer, "post_ms": post_ms}
    print(f"[examples] app on port {port.group(1)}: POST of the PNG -> {json.dumps(answer)} "
          f"({post_ms:.1f} ms), the prediction load_pretrained printed", flush=True)

    with contextlib.redirect_stdout(io.StringIO()):
        pages = vis_demo.main(str(workdir / "vis"))
    sizes = {Path(p).name: Path(p).stat().st_size for p in pages}
    check(len(sizes) == 2 and all(sizes.values()), f"[examples] vis_demo wrote {sizes}")
    out["vis_demo"] = sizes
    print(f"[examples] vis_demo wrote {sizes}", flush=True)
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    check(out["launches"] == {"soft_head": 0, "layernorm": 0, "conv3x3": 0,
                              "bn_act": BN_ACT_PER_REQUEST},
          f"convert and examples launches {out['launches']}")
    shutil.rmtree(workdir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# The surface phase: the JAX package's last public names on the port
# ---------------------------------------------------------------------------


def run_surface_path(workdir: Path, smi: str) -> dict:
    """The last public surface of the JAX package on the port, in a worker
    process with jax, jaxlib, flax, optax and nbdt_tpu blocked: (a) every
    name of the slice imports from the path a user writes and answers on
    CIFAR100's tree; (b) the notebook walkthrough
    (``nbdt_torch/examples/load_pretrained_nbdts.ipynb``) on the card, TF32
    off, and on the CPU from one seeded ResNet18 ``.pth`` and PNG: the same
    soft and hard predictions through the same nodes, each prob within
    SURFACE_PROB_TOL, and the card's ms for one ``forward_with_decisions``;
    (c) ``apply_augment_numpy`` against the native ``augment_batch``. No
    kernel launches, in this process or the worker."""
    from PIL import Image

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    torch.manual_seed(95)
    cifar = ResNet18(10)
    randomize_batchnorm(cifar, torch.Generator().manual_seed(96))
    pth, png = workdir / "resnet18.pth", workdir / "image.png"
    torch.save({"net": cifar.state_dict()}, pth)
    Image.fromarray(np.random.RandomState(97).randint(0, 256, (32, 32, 3), dtype=np.uint8)).save(
        png)
    repo = str(Path(__file__).resolve().parent)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [repo, os.environ.get(
        "PYTHONPATH")]))}
    proc = subprocess.run([sys.executable, "-c", SURFACE_WORKER, repo, str(pth), str(png),
                           "x".join(map(str, SURFACE_AUGMENT)), str(SURFACE_TIMED),
                           json.dumps(SURFACE_NAMES)],
                          env=env, cwd=workdir, capture_output=True, text=True,
                          timeout=SURFACE_DEADLINE)
    check(proc.returncode == 0, f"[surface] the worker failed: {proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    a, b, c = rec["a"], rec["b"], rec["c"]

    check(rec["loaded"] == [], f"[surface] the worker loaded {rec['loaded']}")
    check(a["names"] == {"nbdt_torch": 9, "nbdt_torch.hierarchy": 35} and a["console_mains"],
          f"[surface] (a) names {a}")
    check(a["tables"] == {"CIFAR10": 10, "CIFAR100": 100, "TinyImagenet200": 200,
                          "Imagenet1000": 1000} and a["tables_back_get_dataset_wnids"],
          f"[surface] (a) the wnid tables {a['tables']}")
    check(sum(a["class_counts_root"]) == 100 and a["remove_node"]
          and a["wnid_to_class_index"] == [0, 1, 2], f"[surface] (a) {a}")
    print(f"[surface] (a) {a['names']['nbdt_torch']} loss names from nbdt_torch, "
          f"{a['names']['nbdt_torch.hierarchy']} names from nbdt_torch.hierarchy, the four wnid tables {a['tables']} behind get_dataset_wnids "
          f"with the vendored files hidden, Tree.create_from_args on CIFAR100 (root class "
          f"counts {a['class_counts_root']}, Node.dim of the inodes {a['dim_inodes']}), "
          f"Digraph.remove_node, the nbdt-torch-hierarchy and nbdt-torch-wnids mains; "
          f"jax, jaxlib, flax, optax and nbdt_tpu blocked", flush=True)

    check(b["device"].startswith("cuda") and b["cpu_device"] == "cpu",
          f"[surface] (b) ran on {b['device']} and {b['cpu_device']}")
    check(b["soft"][0] == b["soft"][1] and b["hard"][0] == b["hard"][1],
          f"[surface] (b) card vs CPU predictions soft {b['soft']}, hard {b['hard']}")
    check(b["soft_nodes"][0] == b["soft_nodes"][1] and b["hard_nodes"][0] == b["hard_nodes"][1]
          and len(b["soft_nodes"][0]) >= 2, f"[surface] (b) decision nodes {b}")
    check(b["prob_max_diff"] <= SURFACE_PROB_TOL,
          f"[surface] (b) max |prob card - CPU| {b['prob_max_diff']} > {SURFACE_PROB_TOL}")
    print(f"[surface] (b) the notebook on the card ({b['seconds']:.1f} s, the CPU "
          f"{b['cpu_seconds']:.1f} s): {' // '.join(b['lines'][1:])}", flush=True)
    print(f"[surface] (b) card = CPU: soft {b['soft'][0]}, hard {b['hard'][0]} through "
          f"{' -> '.join(b['hard_nodes'][0])}, max |prob card - CPU| {b['prob_max_diff']:.3g} "
          f"(<= {SURFACE_PROB_TOL})", flush=True)
    print(f"[surface] (b) one forward_with_decisions on the card, 1 image, ResNet18 f32: "
          f"{b['ms']:.4f} ms (events), {b['wall_ms']:.4f} ms wall, median of {b['timed']}; "
          f"{smi}", flush=True)

    check(c["native"] and c["pixels_equal"] and c["max_abs_diff"] <= NATIVE_TOL,
          f"[surface] (c) apply_augment_numpy vs augment_batch {c}")
    print(f"[surface] (c) apply_augment_numpy = native augment_batch at "
          f"{'x'.join(map(str, c['shape']))}: the pixels bit for bit, floats within "
          f"{c['max_abs_diff']:.3g} (<= {NATIVE_TOL}); numpy {c['twin_ms']:.2f} ms, native "
          f"{c['native_ms']:.2f} ms on the host", flush=True)

    torch.cuda.synchronize()
    out = {"imports": a, "notebook": b, "augment": c, "worker_launches": rec["launches"],
           "launches": read_launches(), "seconds": time.perf_counter() - t0}
    zero = {"soft_head": 0, "layernorm": 0, "conv3x3": 0}  # the worker counts B1-B3
    check(out["launches"] == {**zero, "bn_act": 0} and out["worker_launches"] == zero,
          f"[surface] launches {out['launches']}, the worker's {out['worker_launches']}")
    print(f"[surface] kernel launches: {out['launches']} here, {out['worker_launches']} in the "
          f"worker", flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# The docs phase: the port's migration guide, snippet by snippet
# ---------------------------------------------------------------------------


def run_docs_path(workdir: Path, smi: str) -> dict:
    """Every runnable snippet of ``docs/torch/MIGRATION.md`` (the blocks
    that do not start with ``# torch``), in guide order, in a worker
    process with jax, jaxlib, flax, optax and nbdt_tpu blocked and no
    ``NBDT_DEVICE``, so each runs on its default device, the card. Each
    snippet's wall time, its decision path (``decisions[0]`` where it makes
    one) and its kernel launches: none of B1-B3 unless the snippet asks for
    ``fused=True``, and then B1 within TOL of the plain rules."""
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    blocks = re.findall(r"```python\n(.*?)```", DOCS_GUIDE.read_text(), flags=re.S)
    listing = [(i, b) for i, b in enumerate(blocks)
               if next((ln for ln in b.splitlines() if ln.strip()), "").strip() != "# torch"]
    runnable = [i for i, _ in listing]
    (workdir / "snippets.json").write_text(json.dumps(listing))
    repo = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items() if k != "NBDT_DEVICE"}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [repo, os.environ.get("PYTHONPATH")]))
    proc = subprocess.run([sys.executable, "-c", DOCS_WORKER, repo, str(DOCS_GUIDE),
                           DOCS_SCRATCH, str(workdir / "scratch"),
                           str(workdir / "snippets.json")],
                          env=env, cwd=workdir, capture_output=True, text=True,
                          timeout=DOCS_DEADLINE)
    check(proc.returncode == 0, f"[docs] the worker failed: {proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    check(rec["loaded"] == [], f"[docs] the worker loaded {rec['loaded']}")
    snippets = rec["snippets"]
    check([s["snippet"] for s in snippets] == runnable and len(runnable) >= 5,
          f"[docs] ran snippets {[s['snippet'] for s in snippets]} of {runnable}")
    zero = {"soft_head": 0, "layernorm": 0, "conv3x3": 0}  # the worker counts B1-B3
    for s in snippets:
        tag = f"[docs] snippet{s['snippet']}"
        check(s["device"] == "cuda" and s["outputs_device"] in (None, "cuda:0"),
              f"{tag} ran on {s['device']} (outputs on {s['outputs_device']})")
        if s["fused"]:
            check(s["launches"]["soft_head"] > 0
                  and {**s["launches"], "soft_head": 0} == zero,
                  f"{tag} asks for fused=True; launches {s['launches']}")
            check(s["fused_max_abs_diff"] <= TOL,
                  f"{tag} B1 vs the plain rules {s['fused_max_abs_diff']} > {TOL}")
        else:
            check(s["launches"] == zero, f"{tag} launched {s['launches']}")
        path = " -> ".join(s["path"]) if s["path"] else "no decisions"
        fused = (f", B1 within {s['fused_max_abs_diff']:.3g} of the plain rules"
                 if s["fused"] else "")
        print(f"[docs] snippet{s['snippet']} on {s['device']}: {s['seconds']:.2f} s wall, "
              f"path {path}, launches {s['launches']}{fused}; printed "
              f"{' // '.join(s['lines'])[:300]}", flush=True)
    torch.cuda.synchronize()
    out = {"snippets": [{k: v for k, v in s.items() if k != "lines"} for s in snippets],
           "worker_launches": {k: sum(s["launches"][k] for s in snippets) for k in zero},
           "launches": read_launches(), "seconds": time.perf_counter() - t0, "card": smi}
    check(out["launches"] == {**zero, "bn_act": 0},
          f"[docs] launches in this process {out['launches']}")
    print(f"[docs] {len(snippets)} snippets of {DOCS_GUIDE.name} on the card with jax, jaxlib, "
          f"flax, optax and nbdt_tpu blocked: {sum(s['seconds'] for s in snippets):.2f} s of "
          f"snippets; kernel launches {out['worker_launches']} in the worker, "
          f"{out['launches']} here; {smi}", flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# The release path: the port's released-checkpoint parity harness
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def watch_release_eval(rec: dict):
    """Records the next run of the tool's dual-report eval (``vr._evaluate``,
    wrapped for the block, its result unchanged) into ``rec``: the
    classifier's input and output of every batch (the pooled features and
    the tool's logits; the classifier is the one the probe finds), the
    tool's own soft outputs, the eval's host wall, and on the card CUDA
    events around each backbone pass."""
    real = vr._evaluate

    def evaluate(model, hard_rules, valset, batch_size):
        backbone, rules = model.model, model.rules
        feats, logits, soft, events = [], [], [], []

        def record_soft(x):
            out = rules(x)
            soft.append(out.detach())
            return out

        def classifier_io(module, args, out):
            feats.append(args[0].detach())
            logits.append(out.detach())

        handles = [find_classifier(backbone)[1].register_forward_hook(classifier_io)]
        if model.device.type == "cuda":
            def event(*_):
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()

            handles += [backbone.register_forward_pre_hook(event),
                        backbone.register_forward_hook(event)]
            torch.cuda.synchronize()
        model.rules = record_soft
        t0 = time.perf_counter()
        try:
            top1 = real(model, hard_rules, valset, batch_size)
        finally:
            model.rules = rules
            for h in handles:
                h.remove()
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        rec.update(model=model, hard_rules=hard_rules, n=len(valset), top1=top1,
                   wall_s=time.perf_counter() - t0, feats=torch.cat(feats),
                   logits=torch.cat(logits), soft=torch.cat(soft),
                   backbone_ms=[a.elapsed_time(b) for a, b in zip(events[::2], events[1::2])])
        return top1

    vr._evaluate = evaluate
    try:
        yield rec
    finally:
        vr._evaluate = real


release_launches = dict.fromkeys(("soft_head", "layernorm", "conv3x3", "bn_act"), 0)


def run_release_tool(argv: list, device: str = "cuda") -> tuple:
    """``python -m nbdt_torch.tools.verify_release`` in this process on
    ``device``, its eval watched (``watch_release_eval``): (exit code,
    standard output, the watch's record, the JSON report of
    ``--report-out``, seconds of the whole run, peak device bytes). Its
    kernel launches, counted from 0, must be none; they add to
    ``release_launches``."""
    buf, rec = io.StringIO(), {}
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with watch_release_eval(rec), contextlib.redirect_stdout(buf):
        rc = vr.main([*argv, "--device", device])
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    launches = read_launches()
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0, "bn_act": 0},
          f"[release] the tool launched {launches}: {argv}")
    for k, v in launches.items():
        release_launches[k] += v
    report = json.loads(Path(argv[argv.index("--report-out") + 1]).read_text())
    return rc, buf.getvalue(), rec, report, seconds, peak


def release_cpu_jobs(spec: str) -> None:
    """The CPU side of the release path's card-vs-CPU gate, run in a worker
    process beside the card's runs: each job of the JSON list at ``spec``
    runs the tool on the CPU and saves its exit code, output and logits."""
    for job in json.loads(Path(spec).read_text()):
        rc, text, rec, *_ = run_release_tool(job["argv"], "cpu")
        torch.save({"rc": rc, "stdout": text, "logits": rec["logits"],
                    "seconds": rec["wall_s"]}, job["out"])


RELEASE_WORKER = r"""
import sys

import torch

torch.set_num_threads(int(sys.argv[2]))
import chip_smoke

chip_smoke.release_cpu_jobs(sys.argv[1])
"""


def seeded_release_model(ctor, classes: int, image: int, seed: int) -> torch.nn.Module:
    """A backbone with seeded weights on the card: BatchNorm affine drawn by
    ``randomize_batchnorm``, its statistics and the classifier calibrated on
    RELEASE_CAL images of the tool's synthetic pixel distribution through
    its val transform: each pixel 0.65 of one uniform draw and 0.35 of
    another, as LearnableSyntheticDataset blends a uniform class template
    with uniform noise (drawing its 1000 templates at 224px would take
    seconds of the phase)."""
    torch.manual_seed(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    model = ctor(classes)
    randomize_batchnorm(model, gen)
    model = model.to("cuda", memory_format=torch.channels_last)
    rng = np.random.RandomState(seed + 2)
    shape = (RELEASE_CAL, image, image, 3)
    u8 = (0.65 * rng.randint(0, 256, shape) + 0.35 * rng.randint(0, 256, shape)).astype(np.uint8)
    x = torch.as_tensor(LearnableSyntheticDataset.transform_val()(u8), device="cuda")
    calibrate_batchnorm(model, x)
    calibrate_classifier(model, find_classifier(model)[1], x, gen)
    return model.eval()


def release_checkpoints(workdir: Path, r3: Path) -> dict:
    """{row: checkpoint}: R1 and R2 seeded WRN-28-10s saved in the
    reference's layout ({"net": module.-prefixed state dict, "acc",
    "epoch"}) under their released file names, R3 the .pth that the WRN
    path's CLI trained on TinyImagenet200, R4 a seeded EfficientNet-B7b
    state dict in pytorchcv's keys."""
    from nbdt_torch import model_urls
    from nbdt_torch.models import efficientnet_b7b

    ckpts = {}
    for row, arch, dataset, ctor, classes, image, seed in (
            ("R1", "wrn28_10_cifar10", "CIFAR10", wrn28_10_cifar10, 10, 32, 90),
            ("R2", "wrn28_10_cifar100", "CIFAR100", wrn28_10_cifar100, 100, 32, 92),
            ("R4", "efficientnet_b7b", "Imagenet1000", efficientnet_b7b, 1000, 224, 94)):
        model = seeded_release_model(lambda n, c=ctor: c(num_classes=n), classes, image, seed)
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        if row == "R4":
            path = workdir / "efficientnet_b7b-seeded.pth"
            torch.save(sd, path)
        else:
            path = workdir / model_urls[(arch, dataset)].rsplit("/", 1)[-1]
            torch.save({"net": {f"module.{k}": v for k, v in sd.items()}, "acc": 0.0,
                        "epoch": 0}, path)
        ckpts[row] = path
        del model
    check(r3.exists(), f"[release] no checkpoint from the WRN path's CLI at {r3}")
    ckpts["R3"] = r3
    return ckpts


def release_ties(logits: torch.Tensor, jt) -> torch.Tensor:
    """[B] bool: rows where the backbone's two best classes, the soft rules'
    two best leaves (log-probs) or some node's two best children are within
    TOL: the only rows where an error that small can flip a prediction."""
    outs = get_all_node_outputs(logits.float(), jt)
    leaf = soft_leaf_log_probs(outs.log_probs, jt)

    def gap(x):
        top2 = x.topk(2, dim=-1).values
        return top2[..., 0] - top2[..., 1]

    nodes = torch.where(jt.child_mask[None], outs.logits, -torch.inf)
    return (gap(logits.float()) <= TOL) | (gap(leaf) <= TOL) | (gap(nodes) <= TOL).any(-1)


def release_b1_gate(row: str, rec: dict) -> dict:
    """(c) B1 on the tool's run: SoftNBDT(fused=True) over the tool's own
    backbone and tree, its head (B1) on the pooled features of every val
    image that the tool's pass captured, in the tool's batches, against the
    tool's soft outputs: argmax 1.0 on rows whose top-2 leaf log-probs
    differ by more than TOL."""
    model = rec["model"]
    fused = SoftNBDT(model.dataset, model.model, arch=model.arch, tree=model.tree, fused=True,
                     device=model.device)
    feats = rec["feats"]
    D, C = feats.shape[1], model.tree.arrays.num_classes
    before = st.launches
    leaf = torch.cat([st.fused_soft_head(f, fused._head, want_aux=False)[0]
                      for f in feats.split(RELEASE_BATCH)])
    launches = st.launches - before
    want = rec["soft"].log()
    agree, ties, raw = argmax_agreement(leaf, want, TOL)
    err = float((leaf.exp() - rec["soft"]).abs().max())
    print(f"[release] {row} (c) B1 on the tool's features (D={D}, C={C}, "
          f"{st.last_launch['plan'].instance} instance, {launches} launches): argmax {agree} "
          f"against the tool's soft rules ({ties} tie rows within {TOL}, raw {raw}), max "
          f"|leaf prob diff| {err:.3g}", flush=True)
    check(agree == 1.0, f"[release] {row} (c): B1 argmax agreement {agree}")
    check(feats.shape[0] == rec["n"], f"[release] {row} (c): {feats.shape[0]} features captured "
                                      f"of {rec['n']}")
    return {"D": D, "C": C, "argmax_agreement": agree, "tie_rows": ties, "raw": raw,
            "max_leaf_prob_diff": err, "gate_launches": launches,
            "instance": st.last_launch["plan"].instance}


def release_row(row: str, arch: str, dataset: str, n_val: int, ckpt: Path,
                workdir: Path) -> dict:
    """(a) and (c) of one row: the tool on the card in report-only mode,
    then again against its own soft top-1 (tolerance 0.2) and transcript;
    B1 on the first run's features; the first run's images/s, device ms a
    batch, host share and peak memory."""
    base = ["--checkpoint", str(ckpt), "--arch", arch, "--dataset", dataset, "--val",
            "synthetic", "--synthetic-size", str(n_val), "--batch-size", str(RELEASE_BATCH)]
    first = workdir / f"{row}-a.json"
    rc, text, rec, report, seconds, peak = run_release_tool(
        base + ["--report-out", str(first)])
    top1 = [report[k] for k in ("backbone_top1", "nbdt_soft_top1", "nbdt_hard_top1")]
    check(rc == 0 and text.rstrip().endswith("report only)") and report["pass"] is None,
          f"[release] {row} (a) report-only run: exit {rc}, {text[-300:]!r}")
    check(all(0.0 <= t <= 100.0 for t in top1) and report["n_val"] == n_val,
          f"[release] {row} (a): top-1s {top1} of {report['n_val']} images")
    busy = sum(rec["backbone_ms"])
    perf = {"images_per_s": n_val / rec["wall_s"], "eval_s": rec["wall_s"],
            "backbone_ms_per_batch": busy / len(rec["backbone_ms"]),
            "batches": len(rec["backbone_ms"]), "host_share": 1.0 - busy / (rec["wall_s"] * 1e3),
            "peak_bytes": peak, "run_s": seconds}
    print(f"[release] {row} {arch} on {dataset} ({n_val} synthetic images, batch "
          f"{RELEASE_BATCH}): {text.strip().splitlines()[0]}; eval {rec['wall_s']:.2f} s, "
          f"{perf['images_per_s']:.1f} images/s, backbone {perf['backbone_ms_per_batch']:.3f} "
          f"device ms a batch ({perf['batches']} batches), host share "
          f"{perf['host_share']:.4f}, peak {peak / 1e9:.3f} GB; the whole run {seconds:.1f} s",
          flush=True)
    gate_c = release_b1_gate(row, rec)
    del rec

    second = workdir / f"{row}-b.json"
    rc, text, _, again, seconds2, _ = run_release_tool(
        base + ["--expected-top1", str(report["nbdt_soft_top1"]), "--tolerance", "0.2",
                "--reference-transcript", str(first), "--report-out", str(second)])
    check(rc == 0 and text.rstrip().endswith("PASS") and again["pass"] is True
          and again["transcript_mismatches"] == [],
          f"[release] {row} (a) verdict run: exit {rc}, {text[-400:]!r}")
    lines = [line for line in text.splitlines() if line.startswith(("top-1:", "decision"))]
    print(f"[release] {row} (a) again with --expected-top1 {report['nbdt_soft_top1']} "
          f"--tolerance 0.2 --reference-transcript: {' | '.join(lines)} -> PASS "
          f"({seconds2:.1f} s)", flush=True)
    return {"arch": arch, "dataset": dataset, "n_val": n_val, "backbone_top1": top1[0],
            "nbdt_soft_top1": top1[1], "nbdt_hard_top1": top1[2], **perf,
            "verdict_run_s": seconds2, "b1": gate_c}


def release_card_vs_cpu(row: str, arch: str, dataset: str, n_cpu: int, ckpt: Path,
                        cpu: dict, cpu_report: Path, workdir: Path) -> dict:
    """(b) of one row: the tool on the card at the CPU run's size, against
    the CPU run's transcript; its three top-1s equal the CPU's, an image
    whose prediction differs excused only where ``release_ties`` holds on
    the CPU's logits (counted)."""
    out = workdir / f"{row}-card-small.json"
    rc, text, rec, report, *_ = run_release_tool(
        ["--checkpoint", str(ckpt), "--arch", arch, "--dataset", dataset, "--val",
         "synthetic", "--synthetic-size", str(n_cpu), "--batch-size", str(RELEASE_BATCH),
         "--reference-transcript", str(cpu_report), "--report-out", str(out)])
    check(rc == 0 and report["transcript_mismatches"] == [],
          f"[release] {row} (b): the card against the CPU's transcript: exit {rc}, "
          f"{text[-400:]!r}")
    check(cpu["rc"] == 0, f"[release] {row} (b): the CPU run exited {cpu['rc']}")
    want = json.loads(cpu_report.read_text())
    model = rec["model"]
    card_logits, cpu_logits = rec["logits"], cpu["logits"].to("cuda")
    ties = release_ties(cpu_logits, model.rules.jt)
    differ = {}
    for key, fn in (("backbone_top1", lambda x: x), ("nbdt_soft_top1", model.rules),
                    ("nbdt_hard_top1", rec["hard_rules"])):
        bad = fn(card_logits).argmax(1) != fn(cpu_logits).argmax(1)
        differ[key] = int(bad.sum())
        check(bool(ties[bad].all()),
              f"[release] {row} (b): {key} differs card vs CPU on {differ[key]} images, "
              f"{int((bad & ~ties).sum())} of them not ties within {TOL}")
        if not differ[key]:
            check(report[key] == want[key],
                  f"[release] {row} (b): {key} card {report[key]}, CPU {want[key]}")
    print(f"[release] {row} (b) card vs CPU at {n_cpu} images: card "
          f"{[report[k] for k in differ]}, CPU {[want[k] for k in differ]} (images whose "
          f"prediction differs: {json.dumps(differ)}, tie images {int(ties.sum())}); the CPU's "
          f"transcript against the card: "
          f"{next(x for x in text.splitlines() if x.startswith('decision'))}; CPU eval "
          f"{cpu['seconds']:.1f} s", flush=True)
    return {"n": n_cpu, "card": [report[k] for k in differ], "cpu": [want[k] for k in differ],
            "differ": differ, "tie_images": int(ties.sum()), "cpu_eval_s": cpu["seconds"]}


def release_val_real(ckpt: Path, workdir: Path) -> dict:
    """(d) ``--val real`` on a staged CIFAR10 ``test_batch`` of
    RELEASE_REAL seeded images in the loader's pickle format: n_val and the
    published 97.55 in the report, FAIL and exit 1 on random weights; an
    empty root exits with the "No staged" message."""
    import pickle

    root = workdir / "data"
    (root / "cifar-10-batches-py").mkdir(parents=True)
    rng = np.random.RandomState(96)
    with open(root / "cifar-10-batches-py" / "test_batch", "wb") as fh:
        pickle.dump({"data": rng.randint(0, 256, (RELEASE_REAL, 3072)).astype(np.uint8),
                     "labels": rng.randint(0, 10, RELEASE_REAL).tolist()}, fh)
    out = workdir / "real.json"
    base = ["--checkpoint", str(ckpt), "--arch", "wrn28_10_cifar10", "--dataset", "CIFAR10",
            "--val", "real", "--batch-size", str(RELEASE_BATCH)]
    rc, text, rec, report, seconds, _ = run_release_tool(
        base + ["--dataset-root", str(root), "--report-out", str(out)])
    check(rc == 1 and text.rstrip().endswith("FAIL") and report["pass"] is False
          and report["n_val"] == RELEASE_REAL and report["expected_top1"] == 97.55,
          f"[release] (d) --val real: exit {rc}, n_val {report['n_val']}, expected "
          f"{report['expected_top1']}, {text[-300:]!r}")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            vr.main(base + ["--dataset-root", str(workdir / "empty"), "--device", "cuda"])
        staged = "no SystemExit"
    except SystemExit as e:
        staged = str(e)
    check("No staged CIFAR10" in staged, f"[release] (d) an empty root: {staged!r}")
    print(f"[release] (d) --val real on a staged test_batch of {RELEASE_REAL} seeded images: "
          f"{text.strip().splitlines()[0]} -> FAIL, exit 1 ({seconds:.1f} s, "
          f"{RELEASE_REAL / rec['wall_s']:.1f} images/s in the eval); an empty root: "
          f"{staged.splitlines()[-1][:60]}...", flush=True)
    return {"n_val": report["n_val"], "expected_top1": report["expected_top1"],
            "nbdt_soft_top1": report["nbdt_soft_top1"], "exit": rc, "seconds": seconds}


def run_release_path(workdir: Path, r3: Path) -> dict:
    """The release path (``python -m nbdt_torch.tools.verify_release``, the
    port of ``tools/verify_release.py``) on the four rows of its published
    table at their widths (RELEASE_ROWS), through the tool's ``main(argv)``:
    (a) each row report-only, then against its own soft top-1 and
    transcript (PASS); (b) the CPU runs at RELEASE_ROWS' smaller sizes, in
    a worker process while the card runs (a), against the card at those
    sizes; (c) B1 on each row's val features against the tool's soft
    argmax; (d) ``--val real`` on a staged CIFAR10 test_batch. The tool
    launches no kernel, as the JAX tool runs none."""
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    release_launches.update(dict.fromkeys(release_launches, 0))
    ckpts = release_checkpoints(workdir, r3)
    jobs = [{"argv": ["--checkpoint", str(ckpts[row]), "--arch", arch, "--dataset", dataset,
                      "--val", "synthetic", "--synthetic-size", str(n_cpu), "--batch-size",
                      str(RELEASE_BATCH), "--report-out", str(workdir / f"{row}-cpu.json")],
             "out": str(workdir / f"{row}-cpu.pt")}
            for row, arch, dataset, _, n_cpu in RELEASE_ROWS]
    (workdir / "jobs.json").write_text(json.dumps(jobs))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(Path(__file__).resolve().parent), os.environ.get("PYTHONPATH")])),
        "CUDA_VISIBLE_DEVICES": ""}
    worker = subprocess.Popen(
        [sys.executable, "-c", RELEASE_WORKER, str(workdir / "jobs.json"),
         str(RELEASE_CPU_THREADS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    rows = {}
    try:
        for row, arch, dataset, n_val, _ in RELEASE_ROWS:
            rows[row] = release_row(row, arch, dataset, n_val, ckpts[row], workdir)
        log, _ = worker.communicate(timeout=RELEASE_DEADLINE)
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.communicate()
    check(worker.returncode == 0, f"[release] the CPU worker exited {worker.returncode}: "
                                  f"{log[-3000:]}")
    for (row, arch, dataset, _, n_cpu), job in zip(RELEASE_ROWS, jobs):
        cpu = torch.load(job["out"], weights_only=True)
        rows[row]["card_vs_cpu"] = release_card_vs_cpu(
            row, arch, dataset, n_cpu, ckpts[row], cpu,
            workdir / f"{row}-cpu.json", workdir)
    real = release_val_real(ckpts["R1"], workdir)
    launches = dict(release_launches)
    print(f"[release] kernel launches over the tool's runs: {json.dumps(launches)}; B1's "
          f"gate (c) launched {sum(r['b1']['gate_launches'] for r in rows.values())} outside "
          f"them", flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    r3.unlink(missing_ok=True)
    return {"rows": rows, "val_real": real, "launches": launches,
            "b1_gate_launches": sum(r["b1"]["gate_launches"] for r in rows.values())}


def time_path_head(feats: torch.Tensor, hc: st.HeadConstants, label: str) -> dict:
    """B1 on a path's own features and classifier (f32 W): the kernel, its
    plain version and, as a yardstick for the classifier alone,
    ``torch.addmm(b, feats, W)`` with TF32 off, each over PATH_W_SETS
    rotating copies of W; the bound from these inputs."""
    hcs = [hc] + [hc._replace(W=hc.W.clone()) for _ in range(PATH_W_SETS - 1)]
    it = itertools.count()

    def pick():
        return hcs[next(it) % PATH_W_SETS]

    def addmm():
        h = pick()
        return torch.addmm(h.b, feats, h.W)

    B, D = feats.shape
    t = {"ms": time_cuda(lambda: st.fused_soft_head(feats, pick(), want_aux=False)),
         "plain_ms": time_cuda(lambda: st.soft_head_reference(feats, pick(), False)),
         "addmm_ms": time_cuda(addmm), "bound": head_bound_ms(hc, B, D)}
    plan = st.last_launch["plan"]
    t["instance"] = plan.instance
    print(f"[times] soft_head {label} on the path's features, W=float32 ({PATH_W_SETS} W "
          f"copies, {plan.instance} instance, q={plan.q}, rows={plan.rows}, grid "
          f"{st.last_launch['grid']}): kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
          f"addmm (classifier only) {t['addmm_ms']:.5f} ms, bound {t['bound'][0]:.5f} ms "
          f"({t['bound'][1]})", flush=True)
    return t


def time_layernorm() -> dict:
    """B2 at the ViT-B shape (50,432 x 768), f32 and bf16: the kernel, its
    plain version and F.layer_norm on the same tensors. Two rotating inputs
    of 77-155 MB each, more than the 50 MB L2, so reads come from HBM.
    F.layer_norm on CUDA refuses a bf16 input with an f32 affine, so for bf16
    it gets bf16 copies of weight and bias (1.5 KB each; the same work)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = VIT_BATCH * 197
    w = 1 + 0.1 * torch.randn(VIT_DIM, device="cuda", generator=g)
    b = 0.1 * torch.randn(VIT_DIM, device="cuda", generator=g)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bufs = [torch.randn(rows, VIT_DIM, device="cuda", generator=g).to(dtype)
                for _ in range(2)]
        it = itertools.count()
        t = {
            "ms": time_cuda(lambda: ln.fused_layernorm(bufs[next(it) % 2], w, b)),
            "plain_ms": time_cuda(lambda: ln.layernorm_reference(bufs[next(it) % 2], w, b)),
            "library_ms": time_cuda(lambda: F.layer_norm(
                bufs[next(it) % 2], (VIT_DIM,), w.to(dtype), b.to(dtype), 1e-6)),
            "bound": ln_bound_ms(bufs[0]),
        }
        wall, device, _, _ = profile_ms(lambda: ln.fused_layernorm(bufs[next(it) % 2], w, b))
        kernel = {k[:60]: v for k, v in device.items() if "layernorm" in k}
        gbs = 2 * bufs[0].numel() * bufs[0].element_size() / t["ms"] / 1e6
        print(f"[times] layernorm {str(dtype)[6:]} {rows}x{VIT_DIM}: kernel {t['ms']:.5f} ms "
              f"({gbs:.1f} GB/s), plain {t['plain_ms']:.5f} ms, F.layer_norm "
              f"{t['library_ms']:.5f} ms, bound {t['bound'][0]:.5f} ms ({t['bound'][1]}); "
              f"profiler device {json.dumps(kernel)} ms, wall {wall:.5f} ms per call",
              flush=True)
        out[dtype] = t
        del bufs
    return out


BN_ACT_SHAPES = {"resnet18 stage 1": (BATCH, 64, 32, 32), "hrnet branch 0": (32, 48, 130, 130)}


def seeded_bn(C: int, g: torch.Generator) -> torch.nn.BatchNorm2d:
    """An eval ``BatchNorm2d`` on the card with seeded scales, shifts and
    statistics."""
    bn = torch.nn.BatchNorm2d(C).cuda().eval()
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(C, device="cuda", generator=g))
        bn.bias.normal_(0, 0.1, generator=g)
        bn.running_mean.normal_(0, 0.5, generator=g)
        bn.running_var.copy_(0.5 + torch.rand(C, device="cuda", generator=g))
    return bn


def time_bn_act() -> dict:
    """The eval BatchNorm + residual + ReLU pass at ResNet18's first stage
    (8192 images) and HRNetV2-W48's branch 0 (32 images), for each residual
    (none: a block's first conv; the block's input; the shortcut conv's
    output through its BatchNorm): the kernel, its plain version, and the
    library passes it replaces (``F.batch_norm`` in eval, the add,
    ``relu_``). Two rotating inputs of 104 MB to 2.1 GB each, more than the
    50 MB L2, so reads come from HBM. The kernel writes over its input; the
    values it compounds over the timed calls do not change its work."""
    g = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for label, shape in BN_ACT_SHAPES.items():
        bn, rbn = seeded_bn(shape[1], g), seeded_bn(shape[1], g)
        xs = [torch.randn(shape, device="cuda", generator=g) for _ in range(2)]
        r = torch.randn(shape, device="cuda", generator=g)

        def library(x, residual, shortcut_bn):
            y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False,
                             0.0, bn.eps)
            if residual is not None:
                y = y + (residual if shortcut_bn is None else F.batch_norm(
                    residual, shortcut_bn.running_mean, shortcut_bn.running_var,
                    shortcut_bn.weight, shortcut_bn.bias, False, 0.0, shortcut_bn.eps))
            return y.relu_()

        for variant, residual, shortcut_bn in (("none", None, None), ("residual", r, None),
                                               ("residual+bn", r, rbn)):
            it = itertools.count()
            with torch.no_grad():
                t = {
                    "ms": time_cuda(lambda: ba.fused_bn_act(xs[next(it) % 2], bn, residual,
                                                            shortcut_bn)),
                    "plain_ms": time_cuda(lambda: ba.bn_act_reference(
                        xs[next(it) % 2], bn, residual, shortcut_bn)),
                    "library_ms": time_cuda(lambda: library(xs[next(it) % 2], residual,
                                                            shortcut_bn)),
                }
            nbytes = (2 + (residual is not None)) * xs[0].numel() * 4
            t["bound_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
            t["bytes_share"] = t["bound_ms"] / t["ms"]
            print(f"[times] bn_act {label} {list(shape)} {variant}: kernel {t['ms']:.5f} ms "
                  f"({nbytes / t['ms'] / 1e6:.1f} GB/s, {100 * t['bytes_share']:.1f}% of "
                  f"3.35 TB/s), plain {t['plain_ms']:.5f} ms, F.batch_norm + add + relu_ "
                  f"{t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms (bytes)", flush=True)
            out[f"{label}/{variant}"] = t
        del xs, r
    return out


def time_dw_bn_swish() -> dict:
    """The depthwise conv + BatchNorm + swish pass at each of B7b's
    depthwise kinds (EFF_DW_SHAPES) at EFF_BATCH images: the kernel (held to
    its plain version within 1e-5 of the output's largest magnitude: the
    two sum k^2 products in another order), its bound by bytes (the input
    read once, the output written once), its plain version, and the library
    chain it replaces as in ``ConvBlock`` (``F.pad`` at stride 2, ATen's
    depthwise ``F.conv2d``, ``F.batch_norm`` in eval, ``F.silu``). Two
    rotating inputs of 370 MB to 4.4 GB each, more than the 50 MB L2, so
    reads come from HBM; ``request`` sums each kind times its blocks."""
    from nbdt_torch.models.efficientnet import same_pads

    g = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    request = dict.fromkeys(("ms", "bound_ms", "plain_ms", "library_ms"), 0.0)
    for C, side, k, s, blocks in EFF_DW_SHAPES:
        bn = seeded_bn(C, g)
        w = torch.randn(C, 1, k, k, device="cuda", generator=g) / k
        pads = same_pads(side, side, k, s) if s == 2 else [k // 2] * 4
        xs = [torch.randn(EFF_BATCH, C, side, side, device="cuda", generator=g)
              for _ in range(2)]

        def library(x):
            if s == 2:
                x = F.pad(x, pads)
            y = F.conv2d(x, w, stride=s, padding=0 if s == 2 else k // 2, groups=C)
            return F.silu(F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                       False, 0.0, bn.eps))

        it = itertools.count()
        with torch.no_grad():
            got = dw.fused_dw_bn_swish(xs[0], w, bn, s, pads)
            want = dw.dw_bn_swish_reference(xs[0], w, bn, s, pads)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            case = f"dw_bn_swish [{EFF_BATCH}, {C}, {side}, {side}] k{k} s{s} pads {pads}"
            check(err <= 1e-5 * scale, f"{case}: {err:.3g} from its plain version (largest "
                                       f"output {scale:.3g})")
            del got, want
            t = {
                "ms": time_cuda(lambda: dw.fused_dw_bn_swish(xs[next(it) % 2], w, bn, s, pads)),
                "plain_ms": time_cuda(lambda: dw.dw_bn_swish_reference(
                    xs[next(it) % 2], w, bn, s, pads)),
                "library_ms": time_cuda(lambda: library(xs[next(it) % 2])),
                "max_abs_err": err,
                "blocks": blocks,
            }
        side_out = -(-side // s)
        nbytes = 4 * (EFF_BATCH * C * (side * side + side_out * side_out) + C * k * k)
        t["bound_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
        t["bytes_share"] = t["bound_ms"] / t["ms"]
        print(f"[times] {case}: kernel {t['ms']:.5f} ms ({nbytes / t['ms'] / 1e6:.1f} GB/s, "
              f"{100 * t['bytes_share']:.1f}% of 3.35 TB/s), plain {t['plain_ms']:.5f} ms, "
              f"F.pad + conv + F.batch_norm + F.silu {t['library_ms']:.5f} ms, bound "
              f"{t['bound_ms']:.5f} ms (bytes); max |kernel - plain| {err:.3g} of "
              f"{scale:.3g}; x{blocks} a request", flush=True)
        out[f"{C}x{side}_k{k}_s{s}"] = t
        for key in request:
            request[key] += blocks * t[key]
        del xs
    request["bytes_share"] = request["bound_ms"] / request["ms"]
    print(f"[times] dw_bn_swish over a B7b request of {EFF_BATCH} ({EFF_DW_PER_REQUEST} "
          f"passes): kernel {request['ms']:.3f} ms, bound {request['bound_ms']:.3f} ms "
          f"({100 * request['bytes_share']:.1f}%), plain {request['plain_ms']:.3f} ms, library "
          f"chain {request['library_ms']:.3f} ms", flush=True)
    out["request"] = request
    return out


WITNESS_SEED = 2 ** 33 + 26  # as large as the benchmark's own seeds
# (cell, images a request, requests): a few requests of each served CNN cell
WITNESS_CELLS = (("hrnetv2_w48_ade20k.offline", 4, 2), ("resnet18_cifar10.offline", 1024, 2),
                 ("efficientnet_b7b_imagenet1000.offline", 8, 2))
# The kernel path's gap to float64 over the library path's: 0.99 for HRNetV2, 1.68 for
# ResNet18 and 0.99 for B7b on an H100 (the largest gap of a few requests); rounding
# misplaced by a fault reads orders of magnitude above
WITNESS_RATIO = 3


def kernel_witness() -> dict:
    """How far from exact each side of the benchmark's ``prob_gap`` is, on
    its served CNN cells' weights and inputs (``benchmark.harness``, TF32
    off): the class probabilities of the program with its hand-written
    passes (bn_act, dw_bn_swish), of the program on the library's passes,
    and of the f32 reference, each against
    the reference run in float64 (its logits rounded to f32 before the soft
    rules, whose own rounding is about 1e-7 here), and the two program
    sides against the f32 reference, as ``prob_gap`` reads them. The kernel
    path must be no further from float64 than WITNESS_RATIO times the
    library path."""
    from benchmark import cells, harness

    out = {}
    for workload, n, requests in WITNESS_CELLS:
        _, cell, config = cells.cell_files(workload)
        with harness.precision(False):
            ctx = harness.Context(workload, cell, config, WITNESS_SEED, device="cuda")
            ref, rules = ctx.reference(), ctx.rules()
            ref64 = copy.deepcopy(ref).double()
            if cell["kind"] == "seg_closed_loop":
                seg = harness.load_module(harness.BENCH / "traffic" / "seg_closed_loop.py")
                ref32 = seg.SegReferenceServe(ref, rules, tf32=False,
                                              block=cell["params"]["check_block"])
                program = SoftSegNBDT(config["tree"]["dataset"], ctx.program_model(),
                                      tree=ctx.program_tree(), device=ctx.device)
            else:
                ref32 = harness.ReferenceServe(ref, rules, tf32=False)
                program = ctx.serve_system()
            library = OnLibraryPasses(program)
            gaps = dict.fromkeys(("kernel", "library", "reference_f32", "kernel_vs_reference_f32",
                                  "library_vs_reference_f32"), 0.0)
            passes = []
            for i in range(requests):
                x = ctx.images(n, f"witness{i}")
                reset_launches()
                fused = program(x)
                passes.append(ba.launches + dw.launches)
                plain = library(x)
                check(ba.launches + dw.launches == passes[-1], f"{workload}: the library side "
                      "ran bn_act or dw_bn_swish")
                want = ref32(x)
                with torch.no_grad():
                    exact = rules.probs(ref64(x.permute(0, 3, 1, 2).double()).float())
                exact = exact.view_as(want)
                for key, a, b in (("kernel", fused, exact), ("library", plain, exact),
                                  ("reference_f32", want, exact),
                                  ("kernel_vs_reference_f32", fused, want),
                                  ("library_vs_reference_f32", plain, want)):
                    gaps[key] = max(gaps[key], float((a.float() - b).abs().max()))
                del fused, plain, want, exact
        check(min(passes) > 0, f"{workload}: kernel passes a request {passes}")
        print(f"[witness] {workload}, seed {WITNESS_SEED}, {requests} requests of {n}: largest "
              f"class-probability gap to the float64 reference: program with its kernels "
              f"{gaps['kernel']:.4g}, program on the library's passes {gaps['library']:.4g}, "
              f"f32 reference {gaps['reference_f32']:.4g}; to the f32 reference (prob_gap): "
              f"with its kernels {gaps['kernel_vs_reference_f32']:.4g}, on the library's passes "
              f"{gaps['library_vs_reference_f32']:.4g}; kernel passes a request {passes[0]}",
              flush=True)
        check(gaps["kernel"] <= WITNESS_RATIO * gaps["library"],
              f"{workload}: the kernel path is {gaps['kernel']:.3g} from float64, more than "
              f"{WITNESS_RATIO} times the library path's {gaps['library']:.3g}")
        out[workload] = {**gaps, "passes_per_request": passes[0], "requests": requests,
                         "images": n, "seed": WITNESS_SEED}
        del program, library, ref32, ref64, ctx
        torch.cuda.empty_cache()
    return out


def time_soft_head(ta, batch: int, dim: int, seed: int, label: str, w_sets: int = 1,
                   feat_bufs: int = 4) -> dict:
    """B1 at one shape, f32 and bf16 W: the kernel, its plain version and,
    as a yardstick for the classifier part only (never called by the port),
    ``torch.addmm(b, feats, W)`` with TF32 off, each on ``feat_bufs``
    rotating feats buffers and ``w_sets`` rotating sets of constants
    (distinct W)."""
    rng = np.random.RandomState(seed)
    Ws = [(rng.randn(dim, ta.num_classes) / math.sqrt(dim)).astype(np.float32)
          for _ in range(w_sets)]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        hcs = [st.prepare_head_constants(ta, W, None, dtype=dtype) for W in Ws]
        bufs = [torch.rand(batch, dim, device="cuda").to(dtype) for _ in range(feat_bufs)]
        bs = [hc.b.to(dtype) for hc in hcs]
        it = itertools.count()

        def pick():
            i = next(it)
            return bufs[i % feat_bufs], i % w_sets

        def kernel():
            f, j = pick()
            return st.fused_soft_head(f, hcs[j], want_aux=False)

        def plain():
            f, j = pick()
            return st.soft_head_reference(f, hcs[j], False)

        def addmm():
            f, j = pick()
            return torch.addmm(bs[j], f, hcs[j].W)

        t = {"ms": time_cuda(kernel), "plain_ms": time_cuda(plain),
             "addmm_ms": time_cuda(addmm), "bound": head_bound_ms(hcs[0], batch, dim)}
        plan = st.last_launch["plan"]
        t["instance"] = plan.instance
        wall, device, _, _ = profile_ms(kernel)
        k_ms = {k[:40]: round(v, 5) for k, v in device.items() if "soft_head" in k}
        print(f"[times] soft_head {label} W={str(dtype)[6:]} ({w_sets} W sets, {plan.instance} "
              f"instance, q={plan.q}, rows={plan.rows}, grid {st.last_launch['grid']}): kernel "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, addmm (classifier only) "
              f"{t['addmm_ms']:.5f} ms, bound {t['bound'][0]:.5f} ms ({t['bound'][1]}); "
              f"profiler device {json.dumps(k_ms)} ms, wall {wall:.5f} ms per call", flush=True)
        out[dtype] = t
        del bufs, hcs
    return out


def main() -> int:
    # Device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {kind}, {count} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)
    print(f"[device] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    # Build: one nvcc per source, all started together
    t0 = time.perf_counter()
    _build.build_all()
    kernels = ("soft_head", "layernorm", "conv3x3", "bn_act", "dw_bn_swish")
    for name in kernels:
        _build.load_library(name)
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    check(native.available(), f"[build] the native host library: {native.build_error}")
    print(f"[build] native host library {native.library_path().name} (g++ "
          f"{' '.join(native.GXX_FLAGS)}): {time.perf_counter() - t0:.2f} s", flush=True)
    for name in kernels:
        for line in ptxas_report(name):
            print(f"[build] {name} {line}", flush=True)

    # The conv probe's seeded draws (tools/probe_pallas_conv.py's), on the card
    t0 = time.perf_counter()
    conv_inp = probe.make_inputs(BATCH, PROBE_PARITY_BATCH, "cuda")
    print(f"[probe] drew the conv probe's inputs (parity {PROBE_PARITY_BATCH}, batch "
          f"{BATCH}) in {time.perf_counter() - t0:.2f} s", flush=True)

    # Kernels vs their plain versions
    trees = {"CIFAR10": Tree("CIFAR10"), "CIFAR100": Tree("CIFAR100"),
             "TinyImagenet200": Tree("TinyImagenet200"),
             "Imagenet1000": Tree("Imagenet1000"), "synthetic-K3": synthetic_tree()}
    # WRN-28-10's vendored trees (CIFAR100: C=100, TinyImagenet200: C=200)
    wrn_trees = {"CIFAR100 induced-wrn28_10_cifar100":
                 Tree("CIFAR100", hierarchy="induced-wrn28_10_cifar100"),
                 "TinyImagenet200 induced-wrn28_10":
                 Tree("TinyImagenet200", hierarchy="induced-wrn28_10")}
    wrn_c100, wrn_c200 = wrn_trees.values()
    head_err = check_soft_head_kernel(trees, wrn_trees)
    ln_err = check_layernorm_kernel()
    conv_err = check_conv3x3_kernel(conv_inp)
    bn_act_cases = check_bn_act_kernel()

    # Main paths, each with the counts set to 0 just before it
    resnet = run_resnet_path(trees)
    vit = run_vit_path(trees["Imagenet1000"])
    conv_probe = run_conv_probe_path(conv_inp)
    del conv_inp
    t0 = time.perf_counter()
    train = run_training_path(Path(__file__).resolve().parent / "build" / "chip_smoke_train")
    train["seconds"] = time.perf_counter() - t0
    print(f"[train] the training path took {train['seconds']:.1f} s", flush=True)
    native_rec = run_native_phase(train)
    t0 = time.perf_counter()
    wrn = run_wrn_serving(wrn_c100)
    wrn_train = run_wrn_training(wrn_c100,
                                 Path(__file__).resolve().parent / "build" / "chip_smoke_wrn")
    wrn_seconds = time.perf_counter() - t0
    print(f"[wrn] the WRN-28-10 path took {wrn_seconds:.1f} s", flush=True)
    t0 = time.perf_counter()
    zero_shot = run_zero_shot_path(Path(__file__).resolve().parent / "build" / "chip_smoke_zs")
    zero_shot["seconds"] = time.perf_counter() - t0
    print(f"[zero-shot] the zero-shot path took {zero_shot['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    imagenet = run_imagenet_path(
        {"b7b": Tree("Imagenet1000", hierarchy="induced-efficientnet_b7b"),
         "resnet": trees["Imagenet1000"]},
        Path(__file__).resolve().parent / "build" / "chip_smoke_imagenet")
    imagenet["seconds"] = time.perf_counter() - t0
    print(f"[imagenet] the ImageNet path took {imagenet['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    zoo = run_zoo_path(trees["Imagenet1000"],
                       Path(__file__).resolve().parent / "build" / "chip_smoke_zoo")
    zoo["seconds"] = time.perf_counter() - t0
    print(f"[zoo] the zoo path took {zoo['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    export = run_export_path(Path(__file__).resolve().parent / "build" / "chip_smoke_export")
    export["seconds"] = time.perf_counter() - t0
    print(f"[export] the export path took {export['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    parallel = run_parallel_path(Path(__file__).resolve().parent / "build" / "chip_smoke_par")
    parallel["seconds"] = time.perf_counter() - t0
    print(f"[parallel] the parallel path took {parallel['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    seg = run_seg_path()
    seg["seconds"] = time.perf_counter() - t0
    print(f"[seg] the segmentation path took {seg['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    imagenet_train = run_imagenet_training(
        Path(__file__).resolve().parent / "build" / "chip_smoke_imt")
    imagenet_train["seconds"] = time.perf_counter() - t0
    print(f"[imagenet train] the ImageNet training path took {imagenet_train['seconds']:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    examples = run_convert_and_examples(
        Path(__file__).resolve().parent / "build" / "chip_smoke_examples")
    examples["seconds"] = time.perf_counter() - t0
    print(f"[examples] the convert and examples path took {examples['seconds']:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    release = run_release_path(Path(__file__).resolve().parent / "build" / "chip_smoke_release",
                               WRN_CLI_PTH)
    release["seconds"] = time.perf_counter() - t0
    print(f"[release] the release path took {release['seconds']:.1f} s", flush=True)
    surface = run_surface_path(Path(__file__).resolve().parent / "build" / "chip_smoke_surface",
                               smi)
    print(f"[surface] the surface phase took {surface['seconds']:.1f} s", flush=True)
    docs = run_docs_path(Path(__file__).resolve().parent / "build" / "chip_smoke_docs", smi)
    print(f"[docs] the docs phase took {docs['seconds']:.1f} s", flush=True)

    # Kernel times
    head_resnet = time_soft_head(trees["CIFAR10"].arrays, BATCH, FEAT_DIM, 7,
                                 "ResNet18 shape B=8192 D=512 C=10")
    head_vit = time_soft_head(trees["Imagenet1000"].arrays, VIT_BATCH, VIT_DIM, 8,
                              "ViT head shape B=256 D=768 C=1000", HEAD_W_SETS)
    head_wide = time_soft_head(trees["CIFAR100"].arrays, BATCH, 2048, 9,
                               "ResNet50-width head B=8192 D=2048 C=100")
    # WRN-28-10's heads; 40 rotating feats buffers (105 MB in f32) are more
    # than the 50 MB L2, so the feats come from HBM
    head_w100 = time_soft_head(wrn_c100.arrays, WRN_BATCH, WRN_DIM, 10,
                               "WRN-28-10 CIFAR100 head B=1024 D=640 C=100", feat_bufs=40)
    head_w200 = time_soft_head(wrn_c200.arrays, WRN_BATCH, WRN_DIM, 11,
                               "WRN-28-10 TinyImagenet200 head B=1024 D=640 C=200",
                               feat_bufs=40)
    ln_t = time_layernorm()
    bn_act_t = time_bn_act()
    dw_t = time_dw_bn_swish()
    witness = kernel_witness()

    def with_rates(times: dict, batch: int) -> dict:
        """The request times plus images/s for each device (event) time."""
        out = {k: v for k, v in times.items() if k != "launches"}
        out.update({k.replace("_ms_per_request", "_images_per_s"): batch / v * 1e3
                    for k, v in out.items() if k.endswith("_ms_per_request")
                    and "_wall_" not in k})
        return out

    print(json.dumps({"main_path": {
        "resnet18": {"batch": BATCH, "requests_timed": 10, **with_rates(resnet, BATCH)},
        "vit_b16": {"batch": VIT_BATCH, "image": VIT_IMG, "classes": VIT_CLASSES,
                    "requests_timed": TIMED, **with_rates(vit, VIT_BATCH)},
        "conv3x3_probe": {"batch": BATCH, "launches_per_request": conv_probe["launches"],
                          "zero_share": conv_probe["zero_share"],
                          "parity": conv_probe["parity"], "timing": conv_probe["timing"]},
        "train": train,
        "wrn28_10": {"serving": {"batch": WRN_BATCH, "classes": WRN_CLASSES,
                                 "requests": REQUESTS, "requests_timed": WRN_TIMED,
                                 **with_rates(wrn, WRN_BATCH)},
                     "train": wrn_train, "seconds": wrn_seconds},
        "zero_shot": zero_shot,
        "imagenet": {**{name: with_rates(rec, rec["batch"])
                        for name, rec in imagenet["paths"].items() if name != "cli"},
                     "cli": imagenet["paths"]["cli"], "seconds": imagenet["seconds"]},
        "zoo": {**{name: with_rates(rec, rec["batch"]) for name, rec in zoo["paths"].items()
                   if name not in ("cli", "every_name")},
                "every_name": zoo["paths"]["every_name"], "cli": zoo["paths"]["cli"],
                "seconds": zoo["seconds"]},
        "export": export,
        "parallel": parallel,
        "segmentation": seg,
        "imagenet_train": imagenet_train,
        "convert_examples": examples,
        "release": release,
        "surface": surface,
        "docs": docs,
        "native": native_rec,
        "card": smi}}), flush=True)

    f32, bf16 = torch.float32, torch.bfloat16
    conv_t = conv_probe["timing"]

    def head_fields(key: str, head: dict) -> dict:
        """B1's times and bounds at one shape, f32 and bf16 W."""
        out = {}
        for dt, pre in ((f32, ""), (bf16, "bf16_")):
            out.update({f"{key}_{pre}ms": head[dt]["ms"],
                        f"{key}_{pre}plain_ms": head[dt]["plain_ms"],
                        f"{key}_{pre}bound_ms": head[dt]["bound"][0],
                        f"{key}_{pre}bound_by": head[dt]["bound"][1]})
        return out

    imnet = imagenet["paths"]
    b7_head, r50_head = imagenet["heads"]["efficientnet_b7b"], imagenet["heads"]["resnet50"]
    zoo_launches = {arch: zoo["paths"][arch]["launches"]["soft_head"] for arch, *_ in ZOO_PATHS}
    # B1 on each zoo path's head, keyed by arch and shape
    zoo_heads = {f"{arch}_d{dim}_c{IMNET_CLASSES}": zoo["heads"][arch]
                 for arch, _, _, dim in ZOO_PATHS}
    head_launches = (resnet["launches"]["soft_head"] + vit["launches"]["soft_head"]
                     + wrn["launches"]["soft_head"]
                     + imnet["efficientnet_b7b"]["launches"]["soft_head"]
                     + imnet["resnet50"]["launches"]["soft_head"] + sum(zoo_launches.values()))
    print(json.dumps({"kernels": [{
        "name": "soft_head",
        "route": "cuda",
        "source": "nbdt_torch/csrc/soft_head.cu",
        "replaces": "nbdt_tpu/ops/soft_traversal.py:172",
        "launches": head_launches,
        "launches_by_path": {"resnet18": resnet["launches"]["soft_head"],
                             "vit_b16": vit["launches"]["soft_head"],
                             "wrn28_10": wrn["launches"]["soft_head"],
                             "efficientnet_b7b": imnet["efficientnet_b7b"]["launches"]["soft_head"],
                             "resnet50": imnet["resnet50"]["launches"]["soft_head"],
                             "zoo": zoo_launches,
                             "squeezenet1_1":
                             zoo["paths"]["squeezenet1_1"]["launches"]["soft_head"]},
        "max_abs_err": max(head_err, imnet["efficientnet_b7b"]["soft_head_leaf_err"],
                           imnet["resnet50"]["soft_head_leaf_err"],
                           *(zoo["paths"][arch]["soft_head_leaf_err"] for arch in zoo_launches)),
        "ms": head_resnet[f32]["ms"],
        "plain_ms": head_resnet[f32]["plain_ms"],
        "bound_ms": head_resnet[f32]["bound"][0],
        "bound_by": head_resnet[f32]["bound"][1],
        "library_ms": None,
        "bf16_ms": head_resnet[bf16]["ms"],
        "bf16_plain_ms": head_resnet[bf16]["plain_ms"],
        "bf16_bound_ms": head_resnet[bf16]["bound"][0],
        "vit_shape_ms": head_vit[f32]["ms"],
        "vit_shape_plain_ms": head_vit[f32]["plain_ms"],
        "vit_shape_bound_ms": head_vit[f32]["bound"][0],
        "vit_shape_bound_by": head_vit[f32]["bound"][1],
        "vit_shape_bf16_ms": head_vit[bf16]["ms"],
        "vit_shape_bf16_plain_ms": head_vit[bf16]["plain_ms"],
        "vit_shape_bf16_bound_ms": head_vit[bf16]["bound"][0],
        "cifar100_d2048_ms": head_wide[f32]["ms"],
        "cifar100_d2048_plain_ms": head_wide[f32]["plain_ms"],
        "cifar100_d2048_bound_ms": head_wide[f32]["bound"][0],
        "cifar100_d2048_bound_by": head_wide[f32]["bound"][1],
        "cifar100_d2048_bf16_ms": head_wide[bf16]["ms"],
        "cifar100_d2048_bf16_plain_ms": head_wide[bf16]["plain_ms"],
        "cifar100_d2048_bf16_bound_ms": head_wide[bf16]["bound"][0],
        **head_fields("wrn_c100", head_w100),
        **head_fields("wrn_c200", head_w200),
        # on the ImageNet paths' own features and classifiers (f32 W)
        **{f"{key}_{field}": head[field] for key, head in (
            ("b7b_d2560_c1000", b7_head), ("resnet50_d2048_c1000", r50_head))
           for field in ("ms", "plain_ms")},
        **{f"{key}_{field}": head["bound"][i] for key, head in (
            ("b7b_d2560_c1000", b7_head), ("resnet50_d2048_c1000", r50_head))
           for i, field in enumerate(("bound_ms", "bound_by"))},
        # on the zoo paths' own features and classifiers (f32 W)
        **{f"{key}_{field}": head[field] for key, head in zoo_heads.items()
           for field in ("ms", "plain_ms")},
        **{f"{key}_{field}": head["bound"][i] for key, head in zoo_heads.items()
           for i, field in enumerate(("bound_ms", "bound_by"))},
        "launches_on_zoo_cli": zoo["paths"]["cli"]["launches"]["soft_head"],
        "launches_on_imagenet_cli": imnet["cli"]["launches"]["soft_head"],
        "launches_on_training_path": train["launches"]["soft_head"],
        "launches_on_wrn_training_path": wrn_train["launches"]["soft_head"],
        "launches_on_zero_shot_path": zero_shot["launches"]["soft_head"],
        "launches_on_export_path": export["launches"]["soft_head"],
        "launches_on_parallel_path": parallel["launches"]["soft_head"],
        "launches_on_segmentation_path": seg["launches"]["soft_head"],
        "launches_on_imagenet_train_path": imagenet_train["launches"]["soft_head"],
        "launches_on_examples_path": examples["launches"]["soft_head"],
        "launches_on_release_path": release["launches"]["soft_head"],
        "launches_on_surface_path": surface["launches"]["soft_head"],
        "launches_on_docs_path": docs["worker_launches"]["soft_head"],
        # B1 held to the release tool's soft argmax on each row's features
        "release_gate_launches": release["b1_gate_launches"],
        "release_gate_heads": {row: {k: rec["b1"][k] for k in ("D", "C", "instance",
                                                                "argmax_agreement", "tie_rows")}
                               for row, rec in release["rows"].items()},
        "instance_by_shape": {"resnet18": head_resnet[f32]["instance"],
                              "vit_b16": head_vit[f32]["instance"],
                              "cifar100_d2048": head_wide[f32]["instance"],
                              "wrn_c100": head_w100[f32]["instance"],
                              "wrn_c200": head_w200[f32]["instance"],
                              "b7b_d2560_c1000": b7_head["instance"],
                              "resnet50_d2048_c1000": r50_head["instance"],
                              **{key: head["instance"] for key, head in zoo_heads.items()}},
        "classifier_addmm_ms": {  # yardstick for the classifier part only
            "resnet18": head_resnet[f32]["addmm_ms"], "resnet18_bf16": head_resnet[bf16]["addmm_ms"],
            "vit_b16": head_vit[f32]["addmm_ms"], "vit_b16_bf16": head_vit[bf16]["addmm_ms"],
            "cifar100_d2048": head_wide[f32]["addmm_ms"],
            "cifar100_d2048_bf16": head_wide[bf16]["addmm_ms"],
            "wrn_c100": head_w100[f32]["addmm_ms"], "wrn_c100_bf16": head_w100[bf16]["addmm_ms"],
            "wrn_c200": head_w200[f32]["addmm_ms"],
            "wrn_c200_bf16": head_w200[bf16]["addmm_ms"],
            "b7b_d2560_c1000": b7_head["addmm_ms"], "resnet50_d2048_c1000": r50_head["addmm_ms"],
            **{key: head["addmm_ms"] for key, head in zoo_heads.items()}},
    }, {
        "name": "layernorm",
        "route": "cuda",
        "source": "nbdt_torch/csrc/layernorm.cu",
        "replaces": "nbdt_tpu/ops/layernorm.py:24",
        "launches": vit["launches"]["layernorm"],
        "launches_on_training_path": train["launches"]["layernorm"],
        "launches_on_zero_shot_path": zero_shot["launches"]["layernorm"],
        "launches_on_export_path": export["launches"]["layernorm"],
        "launches_on_parallel_path": parallel["launches"]["layernorm"],
        "launches_on_segmentation_path": seg["launches"]["layernorm"],
        "launches_on_imagenet_train_path": imagenet_train["launches"]["layernorm"],
        "launches_on_examples_path": examples["launches"]["layernorm"],
        "launches_on_release_path": release["launches"]["layernorm"],
        "launches_on_surface_path": surface["launches"]["layernorm"],
        "launches_on_docs_path": docs["worker_launches"]["layernorm"],
        "max_abs_err": ln_err[f32],
        "ms": ln_t[f32]["ms"],
        "plain_ms": ln_t[f32]["plain_ms"],
        "bound_ms": ln_t[f32]["bound"][0],
        "bound_by": ln_t[f32]["bound"][1],
        "library_ms": ln_t[f32]["library_ms"],
        "bf16_max_abs_err": ln_err[bf16],
        "bf16_ms": ln_t[bf16]["ms"],
        "bf16_plain_ms": ln_t[bf16]["plain_ms"],
        "bf16_bound_ms": ln_t[bf16]["bound"][0],
        "bf16_library_ms": ln_t[bf16]["library_ms"],
    }, {
        "name": "conv3x3",
        "route": "cuda",
        "source": "nbdt_torch/csrc/conv3x3.cu",
        "replaces": "tools/probe_pallas_conv.py:146",
        "replaces_also": ["tools/probe_pallas_conv.py:201", "tools/probe_pallas_conv.py:270"],
        "launches": conv_probe["launches"]["conv3x3"],
        "launches_on_training_path": train["launches"]["conv3x3"],
        "launches_on_zero_shot_path": zero_shot["launches"]["conv3x3"],
        "launches_on_export_path": export["launches"]["conv3x3"],
        "launches_on_parallel_path": parallel["launches"]["conv3x3"],
        "launches_on_segmentation_path": seg["launches"]["conv3x3"],
        "launches_on_imagenet_train_path": imagenet_train["launches"]["conv3x3"],
        "launches_on_examples_path": examples["launches"]["conv3x3"],
        "launches_on_release_path": release["launches"]["conv3x3"],
        "launches_on_surface_path": surface["launches"]["conv3x3"],
        "launches_on_docs_path": docs["worker_launches"]["conv3x3"],
        "max_abs_err": conv_err,
        "ms": conv_t["kernel"]["ms"],
        "plain_ms": conv_t["plain"]["ms"],
        "bound_ms": conv_probe["bound_ms"],
        "bound_by": conv_probe["bound_by"],
        "library_ms": conv_t["library"]["ms"],
    }, {
        "name": "bn_act",
        "route": "cuda",
        "source": "nbdt_torch/csrc/bn_act.cu",
        "replaces": None,
        "launches": resnet["launches"]["bn_act"] + imnet["resnet50"]["launches"]["bn_act"]
                    + examples["launches"]["bn_act"],
        "launches_by_path": {"resnet18": resnet["launches"]["bn_act"],
                             "resnet50": imnet["resnet50"]["launches"]["bn_act"],
                             "examples": examples["launches"]["bn_act"],
                             "efficientnet_b7b":
                                 imnet["efficientnet_b7b"]["launches"]["bn_act"],
                             "vit_b16": vit["launches"]["bn_act"],
                             "wrn28_10": wrn["launches"]["bn_act"],
                             "training": train["launches"]["bn_act"],
                             "zero_shot": zero_shot["launches"]["bn_act"],
                             "export": export["launches"]["bn_act"],
                             "parallel": parallel["launches"]["bn_act"],
                             "segmentation": seg["launches"]["bn_act"],
                             "imagenet_train": imagenet_train["launches"]["bn_act"],
                             "release": release["launches"]["bn_act"],
                             "surface": surface["launches"]["bn_act"],
                             "docs": docs["launches"]["bn_act"]},
        "cases_equal_to_plain": bn_act_cases,
        "times": bn_act_t,
        "float64_witness": witness,
    }, {
        "name": "dw_bn_swish",
        "route": "cuda",
        "source": "nbdt_torch/csrc/dw_bn_swish.cu",
        "replaces": None,
        "launches": imnet["efficientnet_b7b"]["launches"]["dw_bn_swish"],
        "launches_by_path": {"efficientnet_b7b": imnet["efficientnet_b7b"]["launches"]
                             ["dw_bn_swish"],
                             "resnet50": imnet["resnet50"]["launches"]["dw_bn_swish"]},
        "times": dw_t,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
