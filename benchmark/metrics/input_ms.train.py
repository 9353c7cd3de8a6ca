"""Median device ms of the program's ``input`` span a step over the window:
the gather, augment and normalize of the step's batch (``trainer.py``)."""

from benchmark.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "input")
