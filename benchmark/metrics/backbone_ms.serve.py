"""Median device ms of the program's ``backbone`` span over the window's
requests: ``self.model(..., features_only=True)`` in ``NBDT.forward``, the
ViT's B2 launches included."""

from benchmark.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "backbone")
