"""Median device ms from one ``request`` span's end event to the next
one's start event: the result's copy to the host and the host's
turn-around, which the program does not own."""

from benchmark.program_spans import median_gap_ms


def read(run):
    return median_gap_ms(run, "request")
