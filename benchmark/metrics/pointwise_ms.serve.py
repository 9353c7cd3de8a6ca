"""Median over the window's requests of the device ms of a request's
``pointwise`` spans, summed: each EfficientNet MBConv block's 1x1 expansion
(conv, BatchNorm, swish) and its 1x1 projection (conv, BatchNorm) with the
residual add (``models/efficientnet.py``; 106 spans a request at B7b)."""

from benchmark.request_spans import median_request_ms


def read(run):
    return median_request_ms(run, "pointwise")
