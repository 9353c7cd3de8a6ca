"""Median over the window's requests of the device ms of a request's
``depthwise`` spans, summed: each EfficientNet MBConv block's depthwise
ConvBlock, the SAME pad, the conv, BatchNorm and swish
(``models/efficientnet.py``; 55 spans a request at B7b)."""

from benchmark.request_spans import median_request_ms


def read(run):
    return median_request_ms(run, "depthwise")
