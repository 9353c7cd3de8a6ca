"""Median over the window's requests of the device ms of a request's
``fuse`` spans, summed: the exchange units of HRNetV2's modules (1x1 convs
and bilinear upsampling, stride-2 conv chains, the sums and ReLUs;
``models/hrnet.py``; 8 spans a request at W48)."""

from benchmark.request_spans import median_request_ms


def read(run):
    return median_request_ms(run, "fuse")
