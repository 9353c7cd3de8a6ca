#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nbdt_torch) on one CUDA card.

    python3 chip_smoke.py

Drives soft-NBDT serving with ResNet18 on the CIFAR10 induced hierarchy at
batch 8192 (seeded random weights) through the port's entry points, builds
every hand-written kernel of that path from ``nbdt_torch/csrc/``, holds each
against its plain PyTorch version, and times them with CUDA events. Exits
nonzero, printing no result, when there is no CUDA device or any check
fails. The last line is ``{"ok": true, "device": {...}}``; the line before it
is the per-kernel JSON record.

Phases: device, build, kernel vs plain, main path, serving fn, times.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from nbdt_torch import SoftNBDT, make_serving_fn
from nbdt_torch.data.transforms import CIFAR_MEAN, CIFAR_STD
from nbdt_torch.hierarchy.digraph import Digraph
from nbdt_torch.models import ResNet18
from nbdt_torch.ops import _build
from nbdt_torch.ops import soft_traversal as st
from nbdt_torch.tree import Tree

BATCH = 8192  # the flagship serving batch (bench.py's)
FEAT_DIM = 512  # ResNet18's pooled feature width
REQUESTS = 3
TIMED = 20
# Published H100 SXM peaks (at a 700 W power limit): HBM bytes/s and f32
# (non-tensor-core) FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 tolerance of the kernel vs its plain version: both sum in f32 in
# different orders over D=512 products and up to 17 path steps.
TOL = 1e-4


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def profile_ms(fn, n: int = TIMED) -> tuple:
    """torch.profiler over n calls: (wall ms per call, {kernel name: device
    ms per call}). The dict is empty if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    device = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us and e.device_type == torch.autograd.DeviceType.CUDA:
            device[e.key] = us / n / 1e3
    return wall, device


def head_inputs(ta, seed: int):
    """Post-ReLU pooled features and a classifier at init scale."""
    rng = np.random.RandomState(seed)
    feats = np.abs(rng.randn(BATCH, FEAT_DIM)).astype(np.float32)
    W = (rng.randn(FEAT_DIM, ta.num_classes) / math.sqrt(FEAT_DIM)).astype(np.float32)
    b = (0.1 * rng.randn(ta.num_classes)).astype(np.float32)
    return torch.as_tensor(feats, device="cuda"), W, b


def head_bound_ms(hc: st.HeadConstants, B: int, D: int) -> tuple:
    """Least time for the head on an H100: every input read once and the
    leaf output written once at HBM rate, vs the f32 operations this tree's
    lists need at the f32 peak."""
    consts = (hc.W, hc.b, hc.slot_ptr, hc.slot_cls, hc.slot_w, hc.slot_valid,
              hc.class_ptr, hc.class_slot)
    nbytes = B * D * hc.W.element_size() + sum(t.numel() * t.element_size() for t in consts)
    nbytes += B * hc.num_classes * 4
    S = hc.num_nodes * hc.max_children
    flops = B * (2 * D * hc.num_classes + 2 * hc.slot_cls.numel()
                 + hc.class_slot.numel() + 4 * S)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
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


def calibrate_classifier(model, x: torch.Tensor, gen: torch.Generator) -> None:
    """Seeded classifier over standardized features. Random conv weights map
    every image to nearly the same pooled features, so a plain random head
    predicts one class for all; centring and scaling by a calibration
    batch's feature statistics spreads the logits like a trained head's."""
    with torch.no_grad():
        feats = model(x.permute(0, 3, 1, 2), features_only=True)
        mu, sd = feats.mean(0), feats.std(0) + 1e-6
        C, D = model.linear.weight.shape
        w = torch.randn(C, D, generator=gen).to(x.device) * (3.0 / math.sqrt(D)) / sd
        model.linear.weight.copy_(w)
        model.linear.bias.copy_(-(w @ mu))


def main() -> int:
    # 1. Device
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

    # 2. Build
    t0 = time.perf_counter()
    _build.build_all()
    _build.load_library("soft_head")
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    for line in _build.build_logs.get("soft_head", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    # 3. Kernel vs plain, at B=8192, D=512
    max_err = 0.0
    trees = {"CIFAR10": Tree("CIFAR10"), "CIFAR100": Tree("CIFAR100"),
             "Imagenet1000": Tree("Imagenet1000"), "synthetic-K3": synthetic_tree()}
    for seed, (tname, tree) in enumerate(trees.items()):
        ta = tree.arrays
        feats, W, b = head_inputs(ta, seed)
        valid = torch.as_tensor(ta.child_mask.reshape(-1), device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            hc = st.prepare_head_constants(ta, W, b, dtype=dtype)
            f = feats.to(dtype)
            for want_aux in (True, False):
                got = st.fused_soft_head(f, hc, want_aux=want_aux)
                want = st.soft_head_reference(f, hc, want_aux=want_aux)
                torch.cuda.synchronize()
                case = f"{tname} W={str(dtype)[6:]} aux={want_aux}"
                check(all(bool(torch.isfinite(g).all()) for g in got), f"{case}: non-finite output")
                err = float((got[0] - want[0]).abs().max())
                max_err = max(max_err, err)
                if dtype == torch.float32:
                    check(err <= TOL, f"{case}: leaf max-abs error {err:.3g} > {TOL}")
                else:
                    check(torch.allclose(got[0].exp(), want[0].exp(), rtol=1e-2, atol=1e-4),
                          f"{case}: leaf probabilities beyond 1e-2 relative")
                agree, ties, raw = argmax_agreement(got[0], want[0], TOL)
                check(agree == 1.0, f"{case}: argmax agreement {agree}")
                line = (f"[kernel] {case}: leaf err {err:.3g}, argmax {agree} "
                        f"({ties} tie rows within {TOL}, raw {raw})")
                if want_aux:
                    lerr = float((got[1] - want[1]).abs().max())
                    perr = float((got[2] - want[2])[:, valid].abs().max())
                    pads = got[2][:, ~valid]
                    check(lerr <= TOL and perr <= TOL,
                          f"{case}: aux logits err {lerr:.3g}, logp err {perr:.3g}")
                    check(bool((pads == st.NEG).all()), f"{case}: padded slots not -1e30")
                    line += f", logits err {lerr:.3g}, logp err {perr:.3g}"
                print(line, flush=True)
    del feats, got, want

    # 4. Main path: 3 requests of 8192 NHWC images through SoftNBDT(fused=True)
    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    model = ResNet18(10)
    randomize_batchnorm(model, gen)
    tree = trees["CIFAR10"]
    cgen = torch.Generator(device="cuda").manual_seed(1)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    calibrate_classifier(model, torch.randn(1024, 32, 32, 3, device="cuda", generator=cgen), gen)
    fused = SoftNBDT("CIFAR10", model, tree=tree, fused=True)
    plain = SoftNBDT("CIFAR10", model, tree=tree)
    requests = [torch.randn(BATCH, 32, 32, 3, device="cuda", generator=cgen)
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    st.launches = 0
    outs = [fused(x) for x in requests]
    torch.cuda.synchronize()
    launches = st.launches
    check(launches == REQUESTS, f"soft_head launched {launches} times over {REQUESTS} requests")
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
    print(f"[main] soft_head launches over {REQUESTS} requests: {launches}", flush=True)
    _, decisions = plain.forward_with_decisions(requests[0][:4])
    path = " -> ".join(f"{s['name']} ({s['prob']:.3f})" for s in decisions[0])
    print(f"[main] decision path of image 0: {path}", flush=True)

    # 5. Serving fn: bf16 backbone, folded BN, uint8 input (reported, not gated)
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

    # 6. Times: the kernel at the main-path shape, L2-cold (4 rotating feats
    # buffers, 67 MB > 50 MB of L2), its plain version, and ms per request.
    ta = tree.arrays
    rng = np.random.RandomState(7)
    W = (rng.randn(FEAT_DIM, 10) / math.sqrt(FEAT_DIM)).astype(np.float32)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        hc = st.prepare_head_constants(ta, W, None, dtype=dtype)
        bufs = [torch.rand(BATCH, FEAT_DIM, device="cuda").to(dtype) for _ in range(4)]
        it = itertools.count()
        times[dtype] = {
            "ms": time_cuda(lambda: st.fused_soft_head(bufs[next(it) % 4], hc, want_aux=False)),
            "plain_ms": time_cuda(lambda: st.soft_head_reference(bufs[next(it) % 4], hc, False)),
            "bound": head_bound_ms(hc, BATCH, FEAT_DIM),
        }
        wall, device = profile_ms(
            lambda: st.fused_soft_head(bufs[next(it) % 4], hc, want_aux=False))
        kernel = {k: v for k, v in device.items() if "soft_head" in k}
        print(f"[times] soft_head W={str(dtype)[6:]}: events {times[dtype]['ms']:.5f} ms, "
              f"profiler device {json.dumps(kernel)} ms, wall {wall:.5f} ms per call "
              "under the profiler", flush=True)
        sweep = {tb: round(time_cuda(lambda: st.fused_soft_head(
            bufs[next(it) % 4], hc, block_b=tb, want_aux=False)), 5) for tb in (8, 16, 32, 64)}
        print(f"[times] soft_head W={str(dtype)[6:]} ms by block_b: {json.dumps(sweep)}",
              flush=True)
        del bufs
    x = requests[0]
    wall, device = profile_ms(lambda: fused(x), n=5)
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:5]
    print(f"[times] fused request under the profiler: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms (idle share {1 - busy / wall:.4f}); top kernels "
          f"{json.dumps({k[:60]: round(v, 4) for k, v in top})}", flush=True)
    fused_ms = time_cuda(lambda: fused(x))
    plain_ms = time_cuda(lambda: plain(x))
    serve_ms = time_cuda(lambda: serve(u8))
    print(json.dumps({"main_path": {
        "batch": BATCH, "requests_timed": TIMED, "fused_ms_per_request": fused_ms,
        "plain_ms_per_request": plain_ms, "serving_bf16_folded_uint8_ms_per_request": serve_ms,
        "card": smi}}), flush=True)

    f32, bf16 = times[torch.float32], times[torch.bfloat16]
    print(json.dumps({"kernels": [{
        "name": "soft_head",
        "route": "cuda",
        "source": "nbdt_torch/csrc/soft_head.cu",
        "replaces": "nbdt_tpu/ops/soft_traversal.py:172",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound"][0],
        "bound_by": f32["bound"][1],
        "library_ms": None,
        "bf16_ms": bf16["ms"],
        "bf16_plain_ms": bf16["plain_ms"],
        "bf16_bound_ms": bf16["bound"][0],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
