"""Median device ms of the program's ``backward`` span a step over the
window: ``zero_grad`` and ``total.backward()``."""

from benchmark.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "backward")
