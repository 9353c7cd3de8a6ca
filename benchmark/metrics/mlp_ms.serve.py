"""Median over the window's requests of the device ms of a request's
``mlp`` spans, summed: each Swin block's second half, LN2, fc1, GELU, fc2
and the residual add (``models/swin.py``; 24 spans a request at Swin-B)."""

from benchmark.request_spans import median_request_ms


def read(run):
    return median_request_ms(run, "mlp")
