"""Tracing and step timing.

Counterpart of ``nbdt_tpu/profiling.py``, over ``torch.profiler``:

    from nbdt_torch.profiling import trace, StepTimer, annotate_step

    with trace("/tmp/nbdt-trace"):         # a *.pt.trace.json Perfetto reads
        for step, batch in enumerate(loader):
            with annotate_step("train", step):
                train_step(...)

    timer = StepTimer()
    ...
    timer.tick()                           # per-step wall times
    print(timer.summary())
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the CPU, and the card where there is one, into ``log_dir``: a
    ``<worker>.<time>.pt.trace.json`` that Perfetto and TensorBoard read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate_step(name: str, step: Optional[int] = None):
    """Mark a step in the trace timeline: the ops dispatched inside are
    grouped under ``name#step``."""
    return torch.profiler.record_function(name if step is None else f"{name}#{step}")


class StepTimer:
    """Light per-step wall-clock accumulator (host-side; measures dispatch +
    sync time of whatever the caller blocks on between ticks)."""

    def __init__(self):
        self._last = None
        self.times = []

    def tick(self) -> float:
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        if self._last is not None:
            self.times.append(dt)
        self._last = now
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            # nearest-rank percentile: ceil(0.9n)-1 (int(n*0.9) indexes the
            # MAX for n <= 10, reporting tail outliers as the p90)
            "p90_s": ts[max(0, -(-9 * n // 10) - 1)],
            "max_s": ts[-1],
        }
