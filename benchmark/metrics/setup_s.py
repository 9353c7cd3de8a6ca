"""Set-up: from the process's start to the first timed request or step
(imports, CUDA, building or loading the kernels, weights, inputs, warm-up)."""


def read(run):
    return run.setup_s
