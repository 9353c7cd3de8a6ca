#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nbdt_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's three paths through its entry points, with seeded random
weights: soft-NBDT ResNet18 on the CIFAR10 induced hierarchy at batch 8192,
soft-NBDT ViT-B/16 (224px, 1000 classes, bf16 stream, the fused LayerNorm
kernel) on the Imagenet1000 induced hierarchy at batch 256, and the 3x3 conv
probe (``nbdt_torch.tools.probe_pallas_conv``: ResNet18's L1 conv, 64 -> 64
channels at 32px, + bias + ReLU, bf16) at batch 8192. Builds every
hand-written kernel from ``nbdt_torch/csrc/``, holds each against its plain
PyTorch version, checks each path's launch counts and outputs, and times the
kernels and requests with CUDA events. Exits nonzero, printing no result,
when there is no CUDA device or any check fails. The last line is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel JSON
record.

Phases: device, build, the conv probe's inputs, kernel vs plain (soft_head,
layernorm, conv3x3), ResNet18 main path, its serving fn, ViT-B/16 main path,
its f32 gate, its serving fn, the conv probe path (one request, then the
probe's parity and timing phases), times.
"""

from __future__ import annotations

import itertools
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from nbdt_torch import SoftNBDT, make_serving_fn
from nbdt_torch.data.transforms import CIFAR_MEAN, CIFAR_STD, IMAGENET_MEAN, IMAGENET_STD
from nbdt_torch.hierarchy.digraph import Digraph
from nbdt_torch.models import ResNet18, vit_b16
from nbdt_torch.ops import _build
from nbdt_torch.ops import conv3x3 as conv
from nbdt_torch.ops import layernorm as ln
from nbdt_torch.ops import soft_traversal as st
from nbdt_torch.tools import probe_pallas_conv as probe
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
# f32 tolerance of the LayerNorm kernel vs its plain version
# (tests/test_vit_variants.py's): the two sum a row of D values in f32 in
# different orders, and rsqrtf is within 2 ulp.
LN_TOL = 2e-5


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
    top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
    print(f"[times] {label} under the profiler: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms (idle share {1 - busy / wall:.4f}); top kernels "
          f"{json.dumps({k[:60]: round(v, 4) for k, v in top})}; their instances recorded "
          f"{json.dumps({k[:60]: seen[k] for k, _ in top})}; device ms by aten op "
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
                   case: str, tag: str = "[kernel]") -> float:
    """B1 vs its plain version on the same feats: f32 W within TOL on the
    leaf log-probs (and the aux logits and valid-slot log-probs), bf16 W
    within 1e-2 relative on the leaf probabilities, argmax 1.0 on rows whose
    plain top-2 gap exceeds TOL. Prints the instance and cluster size that
    ran. Returns the leaf max-abs error."""
    got = st.fused_soft_head(feats, hc, want_aux=want_aux)
    want = st.soft_head_reference(feats, hc, want_aux=want_aux)
    torch.cuda.synchronize()
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
    if hc.W.dtype == torch.float32:
        check(err <= TOL, f"{case}: leaf max-abs error {err:.3g} > {TOL}")
    else:
        check(torch.allclose(got[0].exp(), want[0].exp(), rtol=1e-2, atol=1e-4),
              f"{case}: leaf probabilities beyond 1e-2 relative")
    agree, ties, raw = argmax_agreement(got[0], want[0], TOL)
    check(agree == 1.0, f"{case}: argmax agreement {agree}")
    line = (f"{tag} {case} [{plan.instance} q={plan.q} rows={plan.rows} stages={plan.stages} "
            f"lists in smem={plan.lists_in_smem} grid="
            f"{st.last_launch['grid']} resident={st.last_launch['resident']}]: leaf err "
            f"{err:.3g}, argmax {agree} ({ties} tie rows within {TOL}, raw {raw})")
    if want_aux:
        valid = hc.slot_valid.bool()
        lerr = float((got[1] - want[1]).abs().max())
        perr = float((got[2] - want[2])[:, valid].abs().max())
        check(lerr <= TOL and perr <= TOL,
              f"{case}: aux logits err {lerr:.3g}, logp err {perr:.3g}")
        check(bool((got[2][:, ~valid] == st.NEG).all()), f"{case}: padded slots not -1e30")
        line += f", logits err {lerr:.3g}, logp err {perr:.3g}"
    print(line, flush=True)
    instances_seen.add(plan.instance)
    return err


instances_seen: set = set()  # B1 instances that ran in the kernel gates


def check_soft_head_kernel(trees: dict) -> float:
    """B1 vs its plain version: at B=8192, D=512 on four trees and at the
    ViT head's shape (B=256, D=768) on Imagenet1000; ragged B (1, 17, 259)
    at both instances; C = 32 and 33, on either side of the plan's switch
    (K=2 and K=3); C = 300 (3 ranks), 1500 (two classifier passes a rank)
    and 3000 (a shallower W ring, the lists left in global memory); a DAG at each instance; D=100 (bf16 W then takes the
    cluster instance with unvectorized feats). f32 and bf16 W, aux on and
    off. Checks that both instances ran. Returns the largest leaf max-abs
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
              ("DAG C=3", grouped_tree(3, 2, dag=True), 17, FEAT_DIM),
              ("DAG C=40", grouped_tree(40, 2, dag=True), 259, FEAT_DIM),
              ("CIFAR10", trees["CIFAR10"], 17, 100)]
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


def time_soft_head(ta, batch: int, dim: int, seed: int, label: str, w_sets: int = 1) -> dict:
    """B1 at one shape, f32 and bf16 W: the kernel, its plain version and,
    as a yardstick for the classifier part only (never called by the port),
    ``torch.addmm(b, feats, W)`` with TF32 off, each on 4 rotating feats
    buffers and ``w_sets`` rotating sets of constants (distinct W)."""
    rng = np.random.RandomState(seed)
    Ws = [(rng.randn(dim, ta.num_classes) / math.sqrt(dim)).astype(np.float32)
          for _ in range(w_sets)]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        hcs = [st.prepare_head_constants(ta, W, None, dtype=dtype) for W in Ws]
        bufs = [torch.rand(batch, dim, device="cuda").to(dtype) for _ in range(4)]
        bs = [hc.b.to(dtype) for hc in hcs]
        it = itertools.count()

        def pick():
            i = next(it)
            return bufs[i % 4], i % w_sets

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
             "Imagenet1000": Tree("Imagenet1000"), "synthetic-K3": synthetic_tree()}
    head_err = check_soft_head_kernel(trees)
    ln_err = check_layernorm_kernel()
    conv_err = check_conv3x3_kernel(conv_inp)

    # Main paths, each with the counts set to 0 just before it
    resnet = run_resnet_path(trees)
    vit = run_vit_path(trees["Imagenet1000"])
    conv_probe = run_conv_probe_path(conv_inp)
    del conv_inp

    # Kernel times
    head_resnet = time_soft_head(trees["CIFAR10"].arrays, BATCH, FEAT_DIM, 7,
                                 "ResNet18 shape B=8192 D=512 C=10")
    head_vit = time_soft_head(trees["Imagenet1000"].arrays, VIT_BATCH, VIT_DIM, 8,
                              "ViT head shape B=256 D=768 C=1000", HEAD_W_SETS)
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
        "card": smi}}), flush=True)

    f32, bf16 = torch.float32, torch.bfloat16
    conv_t = conv_probe["timing"]
    head_launches = resnet["launches"]["soft_head"] + vit["launches"]["soft_head"]
    print(json.dumps({"kernels": [{
        "name": "soft_head",
        "route": "cuda",
        "source": "nbdt_torch/csrc/soft_head.cu",
        "replaces": "nbdt_tpu/ops/soft_traversal.py:172",
        "launches": head_launches,
        "launches_by_path": {"resnet18": resnet["launches"]["soft_head"],
                             "vit_b16": vit["launches"]["soft_head"]},
        "max_abs_err": head_err,
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
        "instance_by_shape": {"resnet18": head_resnet[f32]["instance"],
                              "vit_b16": head_vit[f32]["instance"]},
        "classifier_addmm_ms": {  # yardstick for the classifier part only
            "resnet18": head_resnet[f32]["addmm_ms"], "resnet18_bf16": head_resnet[bf16]["addmm_ms"],
            "vit_b16": head_vit[f32]["addmm_ms"], "vit_b16_bf16": head_vit[bf16]["addmm_ms"]},
    }, {
        "name": "layernorm",
        "route": "cuda",
        "source": "nbdt_torch/csrc/layernorm.cu",
        "replaces": "nbdt_tpu/ops/layernorm.py:24",
        "launches": vit["launches"]["layernorm"],
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
