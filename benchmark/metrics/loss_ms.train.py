"""Median device ms of the program's ``loss`` span a step over the window:
the cross-entropy, the tree term (``losses.py``) and their total."""

from benchmark.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "loss")
