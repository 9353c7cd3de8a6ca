"""Median host ms of rank 0's step calls in the window, from the call to
its return: what the host takes to launch one step, which bounds the step
where the device waits for it."""


def read(run):
    return getattr(run, "host_step_ms", None)
