"""Median over the window's requests of the device ms of a request's
``branches`` spans, summed: the BasicBlocks of every branch in each module
of HRNetV2's stages 2-4 (``models/hrnet.py``; 8 spans a request at W48)."""

from benchmark.request_spans import median_request_ms


def read(run):
    return median_request_ms(run, "branches")
