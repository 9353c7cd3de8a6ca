"""Median device ms of the program's ``forward`` span a step over the
window: the learning rate set, ``model.train()``, the forward,
``logits.float()``."""

from benchmark.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "forward")
