"""The fused head (``csrc/soft_head.cu``): the least time for one
request's head work (``reference.work.head_work`` from the tree's
structure, W read once) over the mean device time of its launches."""

from benchmark.readers import roofline_percent
from benchmark.reference import work


def read(run):
    w = work.head_work(run.context.hierarchy, run.cell["params"]["batch"],
                       run.config["model"]["feature_dim"])
    return roofline_percent(run, "soft_head_", work.least_seconds(w["flops"], w["bytes"]))
