"""Median device ms from one ``step`` span's end event to the next one's
start event: what runs between two optimizer steps, the host's wait
included."""

from benchmark.program_spans import median_gap_ms


def read(run):
    return median_gap_ms(run, "step")
