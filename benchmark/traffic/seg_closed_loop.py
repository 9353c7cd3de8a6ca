"""Closed loop of segmentation requests, one client: requests of ``batch``
NHWC f32 images sent back to back, each sent when the previous one's
per-pixel class probabilities are on the host. The inputs are a pool of
``pool`` distinct seeded batches made on the device, cycled. Entry:
``SoftSegNBDT(dataset, model, tree=tree)(x)`` -> ``[N, h, w, C]``; the
control is the reference in TF32 behind the same call.

The client copies the window's first ``hold`` results into page-locked host
buffers that set-up allocates, one a request, as a bulk scorer that keeps
its results does; any later result goes to pageable memory (``.cpu()``).
Fresh pageable memory costs a page fault a page on the host, whose time
spread the rate by 9% from run to run on an H100 machine (IQR over median,
six runs, 324 MB results).

Check: every request of the window, against the reference's per-pixel class
probabilities of its pool batch, computed in blocks of ``check_block``
images (``prob_gap``: the largest absolute difference of a class
probability). The window's outputs stay on the host until the check; the
check says on standard error how many bytes they held, of the host's RAM.
"""

from __future__ import annotations

import math
import os
import sys
import time

import torch

from benchmark.harness import ReferenceServe, free_memory, worst


class SegReferenceServe(ReferenceServe):
    """The reference behind the seg wrapper's call: square NHWC images ->
    per-pixel class probabilities ``[N, h, w, C]``."""

    def __call__(self, x):
        rows = super().__call__(x)
        side = math.isqrt(rows.shape[0] // len(x))
        return rows.view(len(x), side, side, rows.shape[1])


def setup(ctx):
    p = ctx.params
    pool = [ctx.images(p["batch"], f"pool{i}") for i in range(p["pool"])]
    if ctx.variant == "control":
        system = SegReferenceServe(ctx.reference(), ctx.rules(), tf32=True)
    else:
        from nbdt_torch.model import SoftSegNBDT

        system = SoftSegNBDT(ctx.config["tree"]["dataset"], ctx.program_model(),
                             tree=ctx.program_tree(), device=ctx.device)
    warm = [system(x) for x in pool[:2]]  # warm-up at the one shape the window sends
    host = []
    if ctx.device.type == "cuda":
        host = list(torch.empty((p["hold"], *warm[0].shape), dtype=warm[0].dtype,
                                pin_memory=True))
    for i, y in enumerate(warm):
        to_host(y, host, i)
    return {"ctx": ctx, "pool": pool, "system": system, "host": host, "outputs": []}


def to_host(y, host, n):
    """Request ``n``'s result on the host: into its page-locked buffer, or
    past the last one by ``.cpu()``."""
    return host[n].copy_(y) if n < len(host) else y.cpu()


def window(state, seconds: float, phases) -> dict:
    system, pool, host, outputs = state["system"], state["pool"], state["host"], state["outputs"]
    n = 0
    t0_ns, t0 = time.time_ns(), time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = time.time_ns()
        y = system(pool[n % len(pool)])
        b = time.time_ns()
        outputs.append((n % len(pool), to_host(y, host, n)))
        c = time.time_ns()
        phases.add(a, b, "call")
        phases.add(b, c, "result_to_host")
        n += 1
    t1, t1_ns = time.perf_counter(), time.time_ns()
    batch = state["ctx"].params["batch"]
    return {"t0_ns": t0_ns, "t1_ns": t1_ns, "window_s": t1 - t0, "attempted": n, "failed": 0,
            "images": n * batch, "requests": n}


def check(state) -> dict:
    ctx, outputs = state["ctx"], state["outputs"]
    state["system"] = None  # the program's state goes before the reference runs
    free_memory(ctx.device)
    held = sum(y.numel() * y.element_size() for _, y in outputs)
    locked = sum(b.numel() * b.element_size() for b in state["host"])
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    print(f"seg_closed_loop: {len(outputs)} outputs held {held} bytes on the host "
          f"({100 * held / ram:.2f}% of its {ram} bytes of RAM), in {locked} bytes "
          f"of page-locked buffers and {held - min(held, locked)} pageable", file=sys.stderr)
    ref = SegReferenceServe(ctx.reference(), ctx.rules(), tf32=False,
                            block=ctx.params["check_block"])
    gap = 0.0 if outputs else float("inf")
    for i, x in enumerate(state["pool"]):
        want = ref(x)
        for j, got in outputs:
            if j == i:
                gap = worst(gap, float((got.to(want.device).float() - want).abs().max())
                            if got.shape == want.shape else float("inf"))
    return {"prob_gap": (gap, ctx.cell["limits"]["prob_gap"])}
