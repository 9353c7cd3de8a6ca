"""Host seconds of the program's ``first_call`` spans in set-up: an NBDT's
first forward or a step function's first call, from call to return, with
the lazy start of CUDA, cuDNN and cuBLAS and the kernels' load."""

from benchmark.program_spans import setup_seconds


def read(run):
    return setup_seconds(run, ("first_call",))
