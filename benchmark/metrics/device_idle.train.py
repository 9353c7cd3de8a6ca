"""Share of the traced window with no operation on the device (profiler)."""

from benchmark.readers import idle_percent


def read(run):
    return idle_percent(run)
