"""Host seconds of set-up covered by the union of the program's set-up
spans (``tree``, ``nbdt_init``, ``kernel_load``, ``first_call``): the share
of ``setup_s`` that the program owns."""

from benchmark.program_spans import setup_seconds


def read(run):
    return setup_seconds(run)
