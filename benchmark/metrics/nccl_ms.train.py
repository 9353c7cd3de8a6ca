"""Device ms a step of the NCCL kernels in rank 0's traced window (every
launch whose name holds ``nccl``: DDP's gradient all-reduce, the
cross-rank BatchNorm's all-gathers and all-reduces, the loss's
all-reduce), time spent waiting for the other ranks inside them
included."""


def read(run):
    if not run.trace or not getattr(run, "steps", None):
        return None
    times = [s for name, s in run.trace["kernels"] if "nccl" in name.lower()]
    return 1000.0 * sum(times) / run.steps if times else None
