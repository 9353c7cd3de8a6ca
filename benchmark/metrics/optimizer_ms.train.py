"""Median device ms of the program's ``optimizer`` span a step over the
window: ``optimizer.step()`` (SGD with momentum and weight decay)."""

from benchmark.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "optimizer")
