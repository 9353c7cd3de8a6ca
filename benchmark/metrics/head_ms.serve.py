"""Median device ms of the program's ``head`` span over the window's
requests: ``fused_soft_head`` (the cast, ``aligned()``, B1), ``torch.exp``
and ``TaggedOutput``."""

from benchmark.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "head")
