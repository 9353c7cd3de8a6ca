"""The LayerNorm kernel (``csrc/layernorm.cu``) on Swin's path: the least
time for a request's LayerNorms (``reference.swin.layernorm_shapes`` from
the configuration's shapes, 53 at five widths for Swin-B; each launch's
input read and output written once at the HBM rate, or its operations at
the f32 peak, whichever is longer, summed) over the kernel's device time a
request (the traced launches' mean times the launches a request)."""

from benchmark.reference import work
from benchmark.reference.swin import layernorm_shapes


def read(run):
    if not run.trace:
        return None
    times = [s for name, s in run.trace["kernels"] if "layernorm_kernel" in name]
    if not times:
        return None
    shapes = layernorm_shapes(run.config["model"], run.cell["params"]["batch"])
    least = sum(work.least_seconds(w["flops"], w["bytes"])
                for w in (work.layernorm_work(rows, dim) for rows, dim in shapes))
    return 100.0 * least / (len(shapes) * sum(times) / len(times))
