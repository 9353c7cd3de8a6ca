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
their bf16 serving fns; the CLI's ``--arch efficientnet_b7b --eval``). Builds every
hand-written kernel from ``nbdt_torch/csrc/``, holds each against its plain
PyTorch version, checks each path's launch counts and outputs, and times the
kernels and requests with CUDA events. Exits nonzero, printing no result,
when there is no CUDA device or any check fails. The last line is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel JSON
record.

Phases: device, build, the conv probe's inputs, kernel vs plain (soft_head,
layernorm, conv3x3), ResNet18 main path, its serving fn, ViT-B/16 main path,
its f32 gate, its serving fn, the conv probe path (one request, then the
probe's parity and timing phases), the training path, the WRN-28-10 serving
and training path, the zero-shot path, the ImageNet path, times.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from nbdt_torch import HardNBDT, SoftNBDT, make_serving_fn
from nbdt_torch import losses as tl
from nbdt_torch.analysis import HardEmbeddedDecisionRules as HardAnalyzer
from nbdt_torch.analysis import SoftEmbeddedDecisionRules as SoftAnalyzer
from nbdt_torch.data import DataLoader, LearnableSyntheticDataset, PrefetchLoader
from nbdt_torch.data.transforms import CIFAR_MEAN, CIFAR_STD, IMAGENET_MEAN, IMAGENET_STD
from nbdt_torch.hierarchy.digraph import Digraph
from nbdt_torch.main import main as train_cli
from nbdt_torch.models import ResNet18, vit_b16, wrn28_10_cifar100
from nbdt_torch.ops import _build
from nbdt_torch.ops import conv3x3 as conv
from nbdt_torch.ops import layernorm as ln
from nbdt_torch.ops import soft_traversal as st
from nbdt_torch.rules import to_device_tree
from nbdt_torch.tools import probe_pallas_conv as probe
from nbdt_torch.trainer import TrainConfig, Trainer, lr_schedule, make_optimizer, make_train_step
from nbdt_torch.tree import Tree

BATCH = 8192  # the flagship serving batch (bench.py's)
FEAT_DIM = 512  # ResNet18's pooled feature width
VIT_BATCH = 256  # tools/probe_vit.py's batch
VIT_IMG = 224
VIT_DIM = 768
VIT_CLASSES = 1000
VIT_LN_PER_REQUEST = 25  # 2 per block x 12 blocks + the final LayerNorm
PROBE_PARITY_BATCH = 64  # tools/probe_pallas_conv.py's --parity-batch
REQUESTS = 3
TIMED = 20
# Published H100 SXM peaks (at a 700 W power limit): HBM bytes/s, f32
# (non-tensor-core) FLOP/s and bf16 tensor-core FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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
R50_BATCH = 256
R50_IMG = 224
R50_DIM = 2048
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


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def reset_launches() -> None:
    st.launches = ln.launches = conv.launches = 0


def read_launches() -> dict:
    return {"soft_head": st.launches, "layernorm": ln.launches, "conv3x3": conv.launches}


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


def head_bound_ms(hc: st.HeadConstants, B: int, D: int) -> tuple:
    """Least time for the head on an H100: every input read once and the
    leaf output written once at HBM rate, vs its operations at their peaks:
    the classifier at the f32 CUDA-core peak for an f32 W (TF32 is ruled
    out) or the bf16 tensor-core peak for a bf16 W, the tree lists' f32
    operations at the f32 peak."""
    consts = (hc.W, hc.b, hc.slot_ptr, hc.slot_cls, hc.slot_w, hc.slot_valid,
              hc.class_ptr, hc.class_slot)
    nbytes = B * D * hc.W.element_size() + sum(t.numel() * t.element_size() for t in consts)
    nbytes += B * hc.num_classes * 4
    S = hc.num_nodes * hc.max_children
    classifier = 2 * B * D * hc.num_classes
    tree = B * (2 * hc.slot_cls.numel() + hc.class_slot.numel() + 4 * S)
    peak = PEAK_F32_FLOPS if hc.W.dtype == torch.float32 else PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (classifier / peak + tree / PEAK_F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def calibrate_classifier(model, classifier, x: torch.Tensor, gen: torch.Generator) -> None:
    """Seeded classifier over standardized features. Random weights map
    every image to nearly the same pooled features, so a plain random head
    predicts one class for all; centring and scaling by a calibration
    batch's feature statistics spreads the logits like a trained head's."""
    with torch.no_grad():
        feats = model(x.permute(0, 3, 1, 2), features_only=True)
        mu, sd = feats.mean(0), feats.std(0) + 1e-6
        C, D = classifier.weight.shape
        w = torch.randn(C, D, generator=gen).to(x.device) * (3.0 / math.sqrt(D)) / sd
        classifier.weight.copy_(w)
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
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 1},
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


def run_resnet_path(trees: dict) -> dict:
    """ResNet18 main path (3 requests of 8192 through SoftNBDT(fused=True))
    and its serving fn. Returns the launches and the request times."""
    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    model = ResNet18(10)
    randomize_batchnorm(model, gen)
    tree = trees["CIFAR10"]
    cgen = torch.Generator(device="cuda").manual_seed(1)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    calibrate_classifier(model, model.linear,
                         torch.randn(1024, 32, 32, 3, device="cuda", generator=cgen), gen)
    fused = SoftNBDT("CIFAR10", model, tree=tree, fused=True)
    plain = SoftNBDT("CIFAR10", model, tree=tree)
    requests = [torch.randn(BATCH, 32, 32, 3, device="cuda", generator=cgen)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    reset_launches()
    outs = [fused(x) for x in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"soft_head": REQUESTS, "layernorm": 0, "conv3x3": 0},
          f"ResNet18 path launches {launches} over {REQUESTS} requests")
    for i, (x, out) in enumerate(zip(requests, outs)):
        ref = plain(x)
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
    want = {"soft_head": REQUESTS, "layernorm": VIT_LN_PER_REQUEST * REQUESTS, "conv3x3": 0}
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
    # 2. HardTreeSupLoss, host-fed through PrefetchLoader (the short last batch trains)
    host_loader = PrefetchLoader(DataLoader(trainset, TRAIN_BATCH, shuffle=True,
                                            transform=trainset.transform_train(),
                                            drop_last=False))
    tr2, hard = train_run("HardTreeSupLoss host-fed", TrainConfig(loss="HardTreeSupLoss", **cfg),
                          init, host_loader, testloader, Tree("CIFAR10"))
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
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0},
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
    check(launches == {"soft_head": REQUESTS, "layernorm": 0, "conv3x3": 0},
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
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0},
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
    check(launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0},
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


def imagenet_images(n: int, img: int, gen: torch.Generator) -> torch.Tensor:
    """Seeded uint8 NHWC images: normal noise around a per-image colour
    (uniform in [32, 224] a channel) at a per-image contrast (std uniform in
    [8, 64]). Images that differ only in their noise (uniform over [0, 255])
    leave pooled features that differ by less than bf16 resolves: in a CPU
    run of resnet50 at 224px the folded bf16 serving fn then agreed with f32
    on 0.125 of rows."""
    mean = torch.rand(n, 1, 1, 3, device="cuda", generator=gen) * 192 + 32
    contrast = torch.rand(n, 1, 1, 1, device="cuda", generator=gen) * 56 + 8
    noise = torch.randn(n, img, img, 3, device="cuda", generator=gen)
    return (mean + contrast * noise).clamp_(0, 255).round_().to(torch.uint8)


def imagenet_normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC images -> f32 with ImageNet's mean and std, as a caller
    normalizes them on the host."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=u8.device)
    std = torch.as_tensor(IMAGENET_STD, device=u8.device)
    return (u8.float() / 255.0 - mean) / std


def imagenet_model(ctor, img: int, seed: int):
    """A backbone on Imagenet1000 with seeded random weights: BatchNorm
    affine drawn by ``randomize_batchnorm``, its statistics and the
    classifier calibrated on IMNET_CAL seeded images of the requests'
    distribution (a 55-block random network calibrated on other inputs
    amplifies the shift: in a CPU run of B7b at 224px, normal noise
    calibrated it and normalized uniform images then reached logits of 2e6),
    on the card in eval mode."""
    torch.manual_seed(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    model = ctor(IMNET_CLASSES)
    randomize_batchnorm(model, gen)
    model = model.to("cuda", memory_format=torch.channels_last)
    x = imagenet_normalize(imagenet_images(
        IMNET_CAL, img, torch.Generator(device="cuda").manual_seed(seed + 2)))
    calibrate_batchnorm(model, x)
    classifier = model.output.fc if hasattr(model, "output") else model.fc
    calibrate_classifier(model, classifier, x, gen)
    return model


def serve_imagenet(name: str, model, tree: Tree, batch: int, img: int, dim: int,
                   seed: int) -> dict:
    """One ImageNet backbone's main path: REQUESTS requests of ``batch``
    normalized NHWC f32 images through SoftNBDT(fused=True) (one B1 launch each, counts
    set to 0 just before) against the plain rules, B1 held to its plain
    version on the path's own features (no less exact than it against f64,
    within TOL; argmax 1.0 on rows whose top-2 gap exceeds TOL), a decision
    path, a profiler line and the request times. Returns the record and the
    wrappers and inputs for the serving fn."""
    cgen = torch.Generator(device="cuda").manual_seed(seed)
    fused = SoftNBDT("Imagenet1000", model, tree=tree, fused=True)
    plain = SoftNBDT("Imagenet1000", model, tree=tree)
    requests = [imagenet_normalize(imagenet_images(batch, img, cgen)) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    reset_launches()
    outs = [fused(x) for x in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"soft_head": REQUESTS, "layernorm": 0, "conv3x3": 0},
          f"{name} path launches {launches} over {REQUESTS} requests")
    for i, (x, out) in enumerate(zip(requests, outs)):
        ref = plain(x)
        check(out.shape == (batch, IMNET_CLASSES) and bool(torch.isfinite(out).all()),
              f"{name} request {i}: bad output {tuple(out.shape)}")
        dev = float((out.sum(1) - 1).abs().max())
        check(dev < 1e-4, f"{name} request {i}: leaf probs sum to 1 only within {dev:.3g}")
        agree, ties, raw = argmax_agreement(out.log(), ref.log(), TOL)
        check(agree == 1.0, f"{name} request {i}: fused vs plain argmax agreement {agree}")
        print(f"[imagenet] {name} request {i}: fused vs plain argmax {agree} ({ties} tie rows, "
              f"raw {raw}), max |prob diff| {float((out - ref).abs().max()):.3g}, max |sum - 1| "
              f"{dev:.3g}, {int(out.argmax(1).unique().numel())} of {IMNET_CLASSES} classes "
              "predicted", flush=True)
    del outs, ref
    print(f"[imagenet] {name} launches over {REQUESTS} requests: {json.dumps(launches)}; "
          f"soft_head {st.last_launch['plan']}, grid {st.last_launch['grid']}", flush=True)
    with torch.no_grad():
        feats = fused.model(requests[0].permute(0, 3, 1, 2), features_only=True)
    check(feats.shape == (batch, dim) and feats.dtype == torch.float32,
          f"{name} features {tuple(feats.shape)} {feats.dtype}")
    head_err = gate_soft_head(feats, fused._head, True,
                              f"soft_head on {name} request 0 features B={batch} D={dim} "
                              f"C={IMNET_CLASSES}", "[imagenet]", exact=True)
    _, decisions = plain.forward_with_decisions(requests[0][:2])
    path = " -> ".join(f"{s['name']} ({s['prob']:.3f})" for s in decisions[0])
    print(f"[imagenet] {name} decision path of image 0 ({len(decisions[0])} steps): {path}",
          flush=True)
    x = requests[0]
    print_profile(f"{name} fused f32 request of {batch} at {img}px",
                  *profile_ms(lambda: fused(x), n=2))
    rec = {"batch": batch, "image": img, "features": dim, "classes": IMNET_CLASSES,
           "requests": REQUESTS, "requests_timed": IMNET_TIMED, "launches": launches,
           "soft_head_leaf_err": head_err,
           "fused_ms_per_request": time_cuda(lambda: fused(x), n=IMNET_TIMED, warmup=1),
           "fused_wall_ms_per_request": wall_ms(lambda: fused(x), n=IMNET_TIMED, warmup=1),
           "plain_ms_per_request": time_cuda(lambda: plain(x), n=IMNET_TIMED, warmup=1)}
    return rec, fused, plain, feats


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
    from nbdt_torch.main import build_datasets, get_parser
    from nbdt_torch.models import efficientnet_b7b, get_model, resnet50
    from nbdt_torch.trainer import make_eval_step

    out, heads = {}, {}
    for name, ctor, tree, batch, img, dim, seed in (
            ("efficientnet_b7b", efficientnet_b7b, trees["b7b"], EFF_BATCH, EFF_IMG, EFF_DIM, 70),
            ("resnet50", resnet50, trees["resnet"], R50_BATCH, R50_IMG, R50_DIM, 80)):
        t0 = time.perf_counter()
        model = imagenet_model(ctor, img, seed)
        rec, fused, plain, feats = serve_imagenet(name, model, tree, batch, img, dim, seed + 3)
        u8 = imagenet_images(batch, img, torch.Generator(device="cuda").manual_seed(seed + 4))
        ref = plain(imagenet_normalize(u8))
        fold = name == "resnet50"
        serve = make_serving_fn(model, tree, bf16=True, fold_bn=fold, uint8_input=True,
                                normalize=(IMAGENET_MEAN, IMAGENET_STD))
        served = serve(u8)
        check(served.shape == (batch, IMNET_CLASSES) and bool(torch.isfinite(served).all()),
              f"{name} serving fn: bad output")
        dev = float((served.sum(1) - 1).abs().max())
        check(dev < 1e-4, f"{name} serving fn: leaf probs sum to 1 only within {dev:.3g}")
        top = ref.argmax(1, keepdim=True)
        raw = float((served.argmax(1) == ref.argmax(1)).float().mean())
        diff = float((served.gather(1, top).log() - ref.gather(1, top).log()).abs().max())
        kind = "bf16+fold_bn+uint8" if fold else "bf16+uint8"
        print(f"[imagenet serving] {name} {kind} vs f32 plain: argmax agreement {raw}, max |diff| "
              f"of the f32 top-1 leaf log-prob {diff:.4g}"
              + (f" (floor {IMNET_BF16_AGREE})" if fold
                 else " (reported, not gated: bf16 rounding on random weights)"), flush=True)
        if fold:
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
        rec.update({f"serving_{kind.replace('+', '_')}_argmax_agreement": raw,
                    f"serving_{kind.replace('+', '_')}_ms_per_request":
                    time_cuda(lambda: serve(u8), n=IMNET_TIMED, warmup=1),
                    "seconds": time.perf_counter() - t0})
        heads[name] = time_path_head(feats, fused._head,
                                     f"{name} head B={batch} D={dim} C={IMNET_CLASSES}")
        out[name] = rec
        del model, fused, plain, serve, feats, u8, ref, served
        torch.cuda.empty_cache()

    # The CLI: the NBDT count equal to the plain rules' on the same seeded logits
    t0 = time.perf_counter()
    argv = ["--arch", "efficientnet_b7b", "--dataset", "Imagenet1000", "--synthetic", "--eval",
            "--hierarchy", "induced-efficientnet_b7b", "--analysis", "SoftEmbeddedDecisionRules",
            "--batch-size", str(IMNET_CLI_BATCH), "--no-progress", "--checkpoint-dir",
            str(workdir)]
    reset_launches()
    acc, text = run_cli(argv)
    torch.cuda.synchronize()
    cli_launches = read_launches()
    _, correct, total = nbdt_line(text, "NBDT-Soft")
    _, testset = build_datasets(get_parser().parse_args(argv))
    torch.manual_seed(0)  # the CLI's seed for its backbone
    model = get_model("efficientnet_b7b", IMNET_CLASSES).to("cuda",
                                                            memory_format=torch.channels_last)
    step = make_eval_step(model, "cuda")
    logits, labels = [], []
    for x, y, v in DataLoader(testset, IMNET_CLI_BATCH, transform=testset.transform_val(),
                              drop_last=False, pad_last=True):
        logits.append(step(torch.as_tensor(x, device="cuda"))[torch.as_tensor(v)])
        labels.append(torch.as_tensor(y)[torch.as_tensor(v)])
    logits, labels = torch.cat(logits), torch.cat(labels).cuda()
    rules = SoftAnalyzer(tree=trees["b7b"]).rules
    hits = int((rules.forward(logits).argmax(1) == labels).sum())
    check((correct, total) == (hits, len(labels)) and total == 2 * IMNET_CLI_BATCH,
          f"CLI efficientnet_b7b: NBDT-Soft {correct}/{total}, the plain rules on the same "
          f"logits {hits}/{len(labels)}")
    check(cli_launches == {"soft_head": 0, "layernorm": 0, "conv3x3": 0},
          f"CLI efficientnet_b7b eval launched kernels: {cli_launches}")
    out["cli"] = {"arch": "efficientnet_b7b", "image": 224, "batch": IMNET_CLI_BATCH,
                  "backbone_acc": acc, "nbdt_soft_correct": correct, "total": total,
                  "launches": cli_launches, "seconds": time.perf_counter() - t0}
    print(f"[imagenet] CLI efficientnet_b7b --synthetic Imagenet1000 224px --eval --analysis "
          f"SoftEmbeddedDecisionRules at batch {IMNET_CLI_BATCH}: backbone {acc:.2f}%, NBDT-Soft "
          f"{correct}/{total}, equal to the plain rules on the same seeded logits; "
          f"{out['cli']['seconds']:.1f} s", flush=True)
    del model, step, logits
    shutil.rmtree(workdir, ignore_errors=True)
    return {"paths": out, "heads": heads}


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
    kernels = ("soft_head", "layernorm", "conv3x3")
    for name in kernels:
        _build.load_library(name)
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
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

    # Main paths, each with the counts set to 0 just before it
    resnet = run_resnet_path(trees)
    vit = run_vit_path(trees["Imagenet1000"])
    conv_probe = run_conv_probe_path(conv_inp)
    del conv_inp
    t0 = time.perf_counter()
    train = run_training_path(Path(__file__).resolve().parent / "build" / "chip_smoke_train")
    train["seconds"] = time.perf_counter() - t0
    print(f"[train] the training path took {train['seconds']:.1f} s", flush=True)
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
    head_launches = (resnet["launches"]["soft_head"] + vit["launches"]["soft_head"]
                     + wrn["launches"]["soft_head"]
                     + imnet["efficientnet_b7b"]["launches"]["soft_head"]
                     + imnet["resnet50"]["launches"]["soft_head"])
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
                             "resnet50": imnet["resnet50"]["launches"]["soft_head"]},
        "max_abs_err": max(head_err, imnet["efficientnet_b7b"]["soft_head_leaf_err"],
                           imnet["resnet50"]["soft_head_leaf_err"]),
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
        "launches_on_imagenet_cli": imnet["cli"]["launches"]["soft_head"],
        "launches_on_training_path": train["launches"]["soft_head"],
        "launches_on_wrn_training_path": wrn_train["launches"]["soft_head"],
        "launches_on_zero_shot_path": zero_shot["launches"]["soft_head"],
        "instance_by_shape": {"resnet18": head_resnet[f32]["instance"],
                              "vit_b16": head_vit[f32]["instance"],
                              "cifar100_d2048": head_wide[f32]["instance"],
                              "wrn_c100": head_w100[f32]["instance"],
                              "wrn_c200": head_w200[f32]["instance"],
                              "b7b_d2560_c1000": b7_head["instance"],
                              "resnet50_d2048_c1000": r50_head["instance"]},
        "classifier_addmm_ms": {  # yardstick for the classifier part only
            "resnet18": head_resnet[f32]["addmm_ms"], "resnet18_bf16": head_resnet[bf16]["addmm_ms"],
            "vit_b16": head_vit[f32]["addmm_ms"], "vit_b16_bf16": head_vit[bf16]["addmm_ms"],
            "cifar100_d2048": head_wide[f32]["addmm_ms"],
            "cifar100_d2048_bf16": head_wide[bf16]["addmm_ms"],
            "wrn_c100": head_w100[f32]["addmm_ms"], "wrn_c100_bf16": head_w100[bf16]["addmm_ms"],
            "wrn_c200": head_w200[f32]["addmm_ms"],
            "wrn_c200_bf16": head_w200[bf16]["addmm_ms"],
            "b7b_d2560_c1000": b7_head["addmm_ms"], "resnet50_d2048_c1000": r50_head["addmm_ms"]},
    }, {
        "name": "layernorm",
        "route": "cuda",
        "source": "nbdt_torch/csrc/layernorm.cu",
        "replaces": "nbdt_tpu/ops/layernorm.py:24",
        "launches": vit["launches"]["layernorm"],
        "launches_on_training_path": train["launches"]["layernorm"],
        "launches_on_zero_shot_path": zero_shot["launches"]["layernorm"],
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
        "max_abs_err": conv_err,
        "ms": conv_t["kernel"]["ms"],
        "plain_ms": conv_t["plain"]["ms"],
        "bound_ms": conv_probe["bound_ms"],
        "bound_by": conv_probe["bound_by"],
        "library_ms": conv_t["library"]["ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
