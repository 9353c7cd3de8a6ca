"""Closed loop, one client: requests of ``batch`` NHWC f32 images sent back
to back, each sent when the previous one's class probabilities are on the
host. The inputs are a pool of ``pool`` distinct seeded batches made on
the device, cycled. Entry: ``SoftNBDT(dataset, model, tree=tree,
fused=True)(x)``.

Check: every request of the window, against the reference's class
probabilities of its pool batch (``prob_gap``: the largest absolute
difference of a class probability).
"""

from __future__ import annotations

import time

from benchmark.harness import ReferenceServe, free_memory, worst


def setup(ctx):
    p = ctx.params
    pool = [ctx.images(p["batch"], f"pool{i}") for i in range(p["pool"])]
    system = ctx.serve_system()
    for x in pool[:2]:  # warm-up at the one shape the window sends
        system(x).cpu()
    return {"ctx": ctx, "pool": pool, "system": system, "outputs": []}


def window(state, seconds: float, phases) -> dict:
    system, pool, outputs = state["system"], state["pool"], state["outputs"]
    n = 0
    t0_ns, t0 = time.time_ns(), time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = time.time_ns()
        y = system(pool[n % len(pool)])
        b = time.time_ns()
        outputs.append((n % len(pool), y.cpu()))
        c = time.time_ns()
        phases.add(a, b, "call")
        phases.add(b, c, "result_to_host")
        n += 1
    t1, t1_ns = time.perf_counter(), time.time_ns()
    batch = state["ctx"].params["batch"]
    return {"t0_ns": t0_ns, "t1_ns": t1_ns, "window_s": t1 - t0, "attempted": n, "failed": 0,
            "images": n * batch, "requests": n}


def check(state) -> dict:
    ctx = state["ctx"]
    state["system"] = None  # the program's state goes before the reference runs
    free_memory(ctx.device)
    ref = ReferenceServe(ctx.reference(), ctx.rules(), tf32=False, block=ctx.params["check_block"])
    gap = 0.0 if state["outputs"] else float("inf")
    for i, x in enumerate(state["pool"]):
        want = ref(x).cpu()
        for j, got in state["outputs"]:
            if j == i:
                gap = worst(gap, float((got.float() - want).abs().max())
                            if got.shape == want.shape else float("inf"))
    return {"prob_gap": (gap, ctx.cell["limits"]["prob_gap"])}
