"""The depthwise layer of EfficientNet's MBConv blocks: the least time for
one request's depthwise convs (``reference.efficientnet.depthwise_work``
from the configuration's shapes: each conv's input read and output written
once in f32, 2 k^2 operations an output) over the median device time of a
request's ``depthwise`` spans (``depthwise_ms.serve``), whatever runs the
layer."""

from benchmark.reference import work
from benchmark.reference.efficientnet import depthwise_work
from benchmark.request_spans import median_request_ms


def read(run):
    ms = median_request_ms(run, "depthwise")
    if not ms:
        return None
    w = depthwise_work(run.config["model"], run.cell["params"]["batch"])
    return 100.0 * work.least_seconds(w["flops"], w["bytes"]) / (ms / 1000)
