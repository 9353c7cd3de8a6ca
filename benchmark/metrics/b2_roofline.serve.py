"""The LayerNorm kernel (``csrc/layernorm.cu``): the least time for one
LayerNorm of a request's tokens (batch x (patches + 1) rows of the hidden
size) over the mean device time of its launches."""

from benchmark.readers import roofline_percent
from benchmark.reference import work


def read(run):
    m = run.config["model"]
    rows = run.cell["params"]["batch"] * ((m["image_size"] // m["patch_size"]) ** 2 + 1)
    w = work.layernorm_work(rows, m["hidden_size"])
    return roofline_percent(run, "layernorm_kernel", work.least_seconds(w["flops"], w["bytes"]))
