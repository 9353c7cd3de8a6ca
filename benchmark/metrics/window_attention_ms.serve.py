"""Median over the window's requests of the device ms of a request's
``window_attention`` spans, summed: each Swin block's first half, LN1, the
gather into windows, W-MSA (qkv, scores, bias and shift mask, softmax,
values, proj), the gather back and the residual add
(``models/swin.py``; 24 spans a request at Swin-B)."""

from benchmark.request_spans import median_request_ms


def read(run):
    return median_request_ms(run, "window_attention")
