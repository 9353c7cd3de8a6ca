"""nbdt_torch.profiling against nbdt_tpu.profiling: the step timer on one
clock, and a torch.profiler trace on the CPU."""

import json

import pytest

from test_torch_port import torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("n", [0, 1, 2, 5, 10, 11, 20])
def test_step_timer_matches_jax(monkeypatch, n):
    """Both timers read the same monkeypatched clock: the same step times
    and the same summary, the nearest-rank p90 included."""
    import time

    from nbdt_tpu.profiling import StepTimer as JStepTimer

    from nbdt_torch.profiling import StepTimer

    ticks = [0.0] + [float(i * i % 7 + 0.25 * i) for i in range(1, n + 1)]
    ticks = list(__import__("itertools").accumulate(ticks))
    summaries = []
    for cls in (JStepTimer, StepTimer):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = cls()
        dts = [timer.tick() for _ in ticks]
        summaries.append((dts, timer.times, timer.summary()))
    assert summaries[0] == summaries[1]
    assert summaries[1][2]["steps"] == n


def test_trace_writes_a_perfetto_trace(tmp_path):
    """A ``*.pt.trace.json`` on the CPU, holding the annotated step."""
    import torch

    from nbdt_torch.profiling import annotate_step, trace

    with trace(str(tmp_path)):
        for step in range(2):
            with annotate_step("train", step):
                torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
        with annotate_step("eval"):
            torch.ones(8).sum()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"train#0", "train#1", "eval", "aten::matmul"} <= names
