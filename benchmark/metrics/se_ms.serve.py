"""Median over the window's requests of the device ms of a request's ``se``
spans, summed: each EfficientNet MBConv block's squeeze-excite, the spatial
mean, two 1x1 convs, swish, the sigmoid and the gate's multiply
(``models/efficientnet.py``; 55 spans a request at B7b)."""

from benchmark.request_spans import median_request_ms


def read(run):
    return median_request_ms(run, "se")
