"""The program's spans of one name summed within each request of the
window (the spans that share a request's ``group``), for a layer that runs
many times a request: the median over the window's requests of that sum, in
device milliseconds. None where there is nothing to read (the control, a
program without the spans, a window no profiler traced)."""

from __future__ import annotations

import statistics

from benchmark.program_spans import program_spans


def median_request_ms(run, name: str):
    per_request = {}
    for s in program_spans(run, run.t0_ns, run.t1_ns):
        if s["name"] == name and s["device_ms"] is not None:
            per_request[s["group"]] = per_request.get(s["group"], 0.0) + s["device_ms"]
    return statistics.median(per_request.values()) if per_request else None
