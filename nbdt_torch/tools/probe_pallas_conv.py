"""Probe of the hand-written 3x3 conv + bias + ReLU kernel at ResNet18's L1
conv shape: 32x32 maps, 64 -> 64 channels, bf16 in and out, f32 sums.

    python -m nbdt_torch.tools.probe_pallas_conv [--batch 8192] \\
        [--parity-batch 64] [--iters 20] [--device cuda]

Counterpart of ``tools/probe_pallas_conv.py``'s ``main``, whose three TPU
layouts of this function are one kernel here
(:mod:`nbdt_torch.ops.conv3x3`). The inputs are that probe's seeded numpy
draws, in its order: ``RandomState(0)``, then the weight ``randn(3,3,64,64)
* 0.05``, the bias ``randn(64) * 0.01``, the parity batch and the timing
batch, both cast to bf16.

1. Parity, at ``--parity-batch``: the kernel against its plain version at
   ``torch.testing.assert_close``'s bf16 tolerance. A failure raises and the
   run exits nonzero. The agreement with ``F.conv2d`` + ReLU (cuDNN on the
   card, with a bf16 bias, since it refuses an f32 one beside a bf16 input)
   is reported only: cuDNN rounds its sum to bf16 before adding the bias.
2. One request: one kernel call at ``--batch``; its output's shape, finiteness
   and share of zeros after the ReLU.
3. Timing, on a card only: the kernel, its plain version and ``F.conv2d`` +
   ``relu_`` (the library yardstick; the port never calls it), each ``--iters``
   calls back to back behind a GPU sleep, by CUDA events, beside the bound.
   At the default batch, x is 1.07 GB, far above the 50 MB L2, so reads come
   from device memory.

One JSON line per measurement, then one with the whole result, which
:func:`run_probe` also returns. ``--device cpu`` runs phases 1 and 2 on the
plain version (the wrapper's CPU path) and measures no time.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import conv3x3
from ..utils import resolve_device

H = W = 32
C = conv3x3.C
DRAW_CHUNK = 256  # images per numpy draw: the same stream as one draw, less host memory
# Published H100 SXM peaks at a 700 W power limit: bf16 tensor-core FLOP/s
# and HBM bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


@dataclass
class ProbeInputs:
    w: torch.Tensor         # [3, 3, 64, 64] bf16, HWIO
    b: torch.Tensor         # [64] f32
    x_parity: torch.Tensor  # [parity_batch, 32, 32, 64] bf16, NHWC
    x: torch.Tensor         # [batch, 32, 32, 64] bf16, NHWC


def make_inputs(batch: int, parity_batch: int, device="cuda") -> ProbeInputs:
    """The JAX probe's draws, in its order, on ``device``."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    w = (rng.randn(3, 3, C, C) * 0.05).astype(np.float32)
    bias = (rng.randn(C) * 0.01).astype(np.float32)

    def draw(n: int) -> torch.Tensor:
        return torch.from_numpy(rng.randn(n, H, W, C).astype(np.float32)).to(device).bfloat16()

    x_parity = draw(parity_batch)
    x = torch.empty(batch, H, W, C, dtype=torch.bfloat16, device=device)
    for i in range(0, batch, DRAW_CHUNK):
        x[i:i + DRAW_CHUNK] = draw(min(DRAW_CHUNK, batch - i))
    return ProbeInputs(torch.from_numpy(w).to(device).bfloat16(),
                       torch.from_numpy(bias).to(device), x_parity, x)


def bound_ms(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> tuple:
    """Least time for the conv on an H100 SXM: x read once and y written
    once, w and b read once, at the HBM rate, vs its multiply-adds at the
    bf16 tensor-core peak. Returns (ms, "bytes" or "operations")."""
    N, h, w_, _ = x.shape
    flops = 2 * N * h * w_ * 9 * C * C
    nbytes = (2 * x.numel() * x.element_size() + w.numel() * w.element_size()
              + b.numel() * b.element_size())
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")


def library_conv(x: torch.Tensor, w_oihw: torch.Tensor, b_bf16: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` + ``relu_`` on the NHWC x viewed as channels_last NCHW;
    the result back as an NHWC view."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b_bf16, padding=1)
    return out.relu_().permute(0, 2, 3, 1)


def library_weights(inp: ProbeInputs) -> tuple:
    """(OIHW channels_last bf16 weight, bf16 bias) for :func:`library_conv`."""
    w = inp.w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return w, inp.b.bfloat16()


def _differ(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = (got.float() - want.float()).abs()
    return {"max_abs_err": float(diff.max()), "share_differing": float((diff > 0).float().mean())}


def check_parity(inp: ProbeInputs) -> dict:
    """The kernel (the plain version on the CPU) against its plain version at
    the parity batch, gated at the bf16 ``assert_close`` defaults; cuDNN's
    agreement reported beside it."""
    got = conv3x3.conv3x3_bias_relu(inp.x_parity, inp.w, inp.b)
    want = conv3x3.conv3x3_bias_relu_reference(inp.x_parity, inp.w, inp.b)
    torch.testing.assert_close(got, want, msg=lambda m: f"conv3x3 parity failed: {m}")
    lib = library_conv(inp.x_parity, *library_weights(inp))
    return {"vs_plain": _differ(got, want), "vs_library_reported": _differ(got, lib)}


def request(inp: ProbeInputs) -> torch.Tensor:
    """One probe request: one kernel call on the whole timing batch."""
    return conv3x3.conv3x3_bias_relu(inp.x, inp.w, inp.b)


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms per call over ``iters`` back-to-back calls, CUDA
    events, after warm-up. A GPU-side sleep first lets the host queue all
    calls, so host launch overhead opens no gaps between them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms of GPU clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_probe(inp: ProbeInputs, iters: int) -> dict:
    """Kernel, plain version and library pair at the timing batch."""
    bound, by = bound_ms(inp.x, inp.w, inp.b)
    flops = 2 * inp.x.shape[0] * H * W * 9 * C * C
    w_lib, b_lib = library_weights(inp)
    fns = {
        "kernel": lambda: request(inp),
        "plain": lambda: conv3x3.conv3x3_bias_relu_reference(inp.x, inp.w, inp.b),
        "library": lambda: library_conv(inp.x, w_lib, b_lib),
    }
    out = {}
    for name, fn in fns.items():
        ms = time_cuda(fn, iters)
        out[name] = {"ms": ms, "tflops": flops / ms / 1e9, "bound_ms": bound, "bound_by": by,
                     "share_of_bound": bound / ms}
        print(json.dumps({f"conv3x3 {name}": out[name]}), flush=True)
    return out


def run_probe(batch: int, parity_batch: int, iters: int, device="cuda",
              inputs: Optional[ProbeInputs] = None) -> dict:
    """Parity, one request and (on a card) the timings; prints one JSON line
    per measurement and returns them all. ``inputs``, if given, are
    :func:`make_inputs` of the same sizes, reused instead of drawn again."""
    device = resolve_device(device)
    inp = make_inputs(batch, parity_batch, device) if inputs is None else inputs
    if inp.x.shape[0] != batch or inp.x_parity.shape[0] != parity_batch:
        raise ValueError(f"inputs hold batches {inp.x.shape[0]} and {inp.x_parity.shape[0]}, "
                         f"not {batch} and {parity_batch}")
    result = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "batch": batch, "parity_batch": parity_batch}
    result["parity"] = check_parity(inp)
    print(json.dumps({"parity": result["parity"]}), flush=True)

    before = conv3x3.launches
    y = request(inp)
    result["request"] = {
        "launches": conv3x3.launches - before,
        "shape": list(y.shape),
        "finite": bool(torch.isfinite(y).all()),
        "zero_share": float((y == 0).float().mean()),
    }
    del y
    print(json.dumps({"request": result["request"]}), flush=True)
    bound, by = bound_ms(inp.x, inp.w, inp.b)
    result["bound_ms"], result["bound_by"] = bound, by
    result["timing"] = time_probe(inp, iters) if device.type == "cuda" else None
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--parity-batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run_probe(args.batch, args.parity_batch, args.iters, args.device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
