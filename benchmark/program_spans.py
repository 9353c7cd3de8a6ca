"""What the per-layer metrics of the program's own spans share: the spans
``nbdt_torch.profiling.spans`` kept in a run (the layer spans of the traced
window; the set-up spans before it, which always record), read into a
median of device milliseconds, a median gap between a window's requests or
steps on the device, or host seconds of set-up. Each returns None where
there is nothing to read: the control variant, a program without spans, a
window no profiler traced."""

from __future__ import annotations

import statistics

SETUP = ("tree", "nbdt_init", "kernel_load", "first_call")


def program_spans(run, t0_ns: int, t1_ns: int) -> list:
    """The program's spans that started in ``[t0_ns, t1_ns)``; none for the
    control or where the program keeps no spans."""
    if run.context.variant != "program":
        return []
    from nbdt_torch import profiling

    read = getattr(profiling, "spans", None)
    return read(t0_ns, t1_ns) if read is not None else []


def _timed(run, name: str) -> list:
    return [s for s in program_spans(run, run.t0_ns, run.t1_ns)
            if s["name"] == name and s["device_ms"] is not None]


def median_device_ms(run, name: str):
    """Median device milliseconds of the window's ``name`` spans."""
    ms = [s["device_ms"] for s in _timed(run, name)]
    return statistics.median(ms) if ms else None


def median_gap_ms(run, name: str):
    """Median device milliseconds from one ``name`` span's end event to the
    next one's start event, over the window."""
    timed = sorted(_timed(run, name), key=lambda s: s["device_start_ms"])
    gaps = [b["device_start_ms"] - a["device_end_ms"] for a, b in zip(timed, timed[1:])
            if a["device"] == b["device"]]
    return statistics.median(gaps) if gaps else None


def setup_seconds(run, names=SETUP):
    """Host seconds covered by the union of the ``names`` spans of the
    run's set-up: the set-up spans that ended before the window and started
    no more than ``setup_s`` before the last of them ended (the set-up ends
    at or after that, and a traced run starts its profiler between the
    set-up and the window, so the window's start is no anchor)."""
    before = [s for s in program_spans(run, None, run.t0_ns)
              if s["name"] in SETUP and s["end_ns"] <= run.t0_ns]
    if not before:
        return None
    start = max(s["end_ns"] for s in before) - int(run.setup_s * 1e9)
    spans = sorted((s["start_ns"], s["end_ns"]) for s in before
                   if s["name"] in names and s["start_ns"] >= start)
    if not spans:
        return None
    covered, end = 0, spans[0][0]
    for a, b in spans:
        covered += max(0, b - max(a, end))
        end = max(end, b)
    return covered / 1e9
