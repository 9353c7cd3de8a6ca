"""Swin's windowed attention: the least time for one request's
``window_attention`` layers (``reference.swin.window_attention_work`` from
the configuration's shapes: each block's products at the f32 peak or its
input, output, weights and bias table once at the HBM rate, whichever is
longer, summed over the blocks) over the median device time of a request's
``window_attention`` spans (``window_attention_ms.serve``), whatever runs
the layer."""

from benchmark.reference import work
from benchmark.reference.swin import window_attention_work
from benchmark.request_spans import median_request_ms


def read(run):
    ms = median_request_ms(run, "window_attention")
    if not ms:
        return None
    blocks = window_attention_work(run.config["model"], run.cell["params"]["batch"])
    least = sum(work.least_seconds(b["flops"], b["bytes"]) for b in blocks)
    return 100.0 * least / (ms / 1000)
