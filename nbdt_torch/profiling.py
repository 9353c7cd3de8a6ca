"""Tracing, spans and step timing.

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

Spans (the port's own; the JAX package has none). The program opens one
:func:`span` at each layer boundary of its entry points: ``request`` >
``backbone``, ``head`` in ``NBDT.forward``; ``step`` > ``input``,
``forward``, ``loss``, ``backward``, ``optimizer`` in the steps of
``trainer.make_train_step``; and the set-up spans ``tree``
(``Tree.__init__``), ``nbdt_init`` (``NBDT.__init__``), ``kernel_load``
(``ops/_build.py``, ``built=True`` where nvcc ran) and ``first_call`` (an
NBDT's first forward, a step function's first call). A span records its
name, its id, its parent's id, the id of its request or step (its root
span's), host start and end on ``time.time_ns()`` (the clock of the
profiler's event stamps), its attributes, and, for work on a CUDA device,
two CUDA events that :func:`spans` resolves to device milliseconds after
one synchronize. It runs inside ``torch.profiler.record_function(name)``,
so ``trace`` shows the train step's layers and the request's. The layer
spans record only while a ``torch.profiler`` session records and cost one
flag test otherwise; the set-up spans always record host times. Records
are kept in memory, the last ``SPAN_CAPACITY``, with a count of the ones
dropped; the profiler's trace is the exporter:

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        probs = nbdt(x)
    for s in spans(t0_ns, t1_ns):          # dicts, in order of start
        print(s["name"], s["parent"], s["device_ms"])
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import Callable, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_CAPACITY = 65_536  # records kept; older ones are dropped and counted


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


class _Record:
    __slots__ = ("name", "id", "parent", "group", "attrs", "start_ns", "end_ns", "device",
                 "events", "device_ms", "device_start_ms", "device_end_ms")

    def as_dict(self) -> dict:
        out = {k: getattr(self, k) for k in self.__slots__ if k != "events"}
        out["attrs"] = dict(self.attrs)
        return out


class SpanBuffer:
    """The last ``capacity`` span records of the process, and how many
    older ones were dropped."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.records = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._origins = {}  # device -> the first span event recorded on it

    def open(self, name: str, parent: Optional[_Record], attrs: dict) -> _Record:
        r = _Record()
        r.start_ns = time.time_ns()
        r.name, r.attrs, r.end_ns, r.device, r.events = name, attrs, None, None, None
        r.device_ms = r.device_start_ms = r.device_end_ms = None
        with self._lock:
            r.id = next(self._ids)
            r.parent = parent.id if parent is not None else None
            r.group = parent.group if parent is not None else r.id
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(r)
        return r

    def record_event(self, r: _Record, device: torch.device) -> None:
        """One timing event on ``device``'s current stream, the span's start
        or (the second) its end."""
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        if r.events is None:
            r.device, r.events = str(device), [event]
            self._origins.setdefault(r.device, event)
        else:
            r.events.append(event)

    def read(self, t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> List[dict]:
        with self._lock:
            closed = [r for r in self.records if r.end_ns is not None
                      and (t0_ns is None or r.start_ns >= t0_ns)
                      and (t1_ns is None or r.start_ns < t1_ns)]
            pending = [r for r in closed if r.events is not None]
            for device in sorted({r.device for r in pending}):
                torch.cuda.synchronize(device)
            for r in pending:
                origin, (start, end) = self._origins[r.device], r.events
                r.device_start_ms = origin.elapsed_time(start)
                r.device_end_ms = origin.elapsed_time(end)
                r.device_ms = start.elapsed_time(end)
                r.events = None
            return [r.as_dict() for r in closed]

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
            self.dropped = 0


_BUFFER = SpanBuffer()
_local = threading.local()  # each thread's stack of open spans


class _Span:
    __slots__ = ("name", "device", "attrs", "record", "_function")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.attrs, self._function = name, attrs, None
        device = torch.device(device) if device is not None else None
        self.device = device if device is not None and device.type == "cuda" else None

    def __enter__(self) -> dict:
        stack = _local.__dict__.setdefault("stack", [])
        self.record = r = _BUFFER.open(self.name, stack[-1] if stack else None, self.attrs)
        stack.append(r)
        if _autograd_profiler._is_profiler_enabled:
            self._function = torch.profiler.record_function(self.name)
            self._function.__enter__()
            if self.device is not None:
                _BUFFER.record_event(r, self.device)
        return self.attrs

    def __exit__(self, *exc) -> bool:
        r = self.record
        if r.events is not None:
            _BUFFER.record_event(r, self.device)
        if self._function is not None:
            self._function.__exit__(*exc)
        r.end_ns = time.time_ns()
        _local.stack.pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device=None, always: bool = False, **attrs):
    """A context manager around one layer's work: ``name``, with ``attrs``,
    timed on the host and, where ``device`` is a CUDA device, on its
    current stream. It records only while a ``torch.profiler`` session
    records, or with ``always`` (the set-up spans: host times alone when no
    session records); otherwise it does nothing. Entering it gives the
    record's ``attrs``, which the body may extend."""
    if not (always or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device, attrs)


def setup_span(name: str) -> Callable:
    """Decorator: every call of the function in an always-on span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, always=True):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def first_call_span(fn: Callable) -> Callable:
    """``fn`` with its first call, from call to return, in an always-on
    ``first_call`` span (the lazy start of CUDA, cuDNN and cuBLAS, and the
    kernels' load)."""
    called = False

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        nonlocal called
        if called:
            return fn(*args, **kwargs)
        called = True
        with span("first_call", always=True):
            return fn(*args, **kwargs)
    return wrapped


def spans(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> List[dict]:
    """The closed spans that started in ``[t0_ns, t1_ns)`` (either end
    open), in order of start: dicts of ``name``, ``id``, ``parent``,
    ``group`` (the request's or step's id), ``attrs``, ``start_ns`` and
    ``end_ns`` (``time.time_ns()``), ``device`` and, on a CUDA device,
    ``device_ms`` and ``device_start_ms``/``device_end_ms`` (milliseconds
    from the first span event on that device; ``None`` for host spans).
    Synchronizes each device that has events to resolve."""
    return _BUFFER.read(t0_ns, t1_ns)


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
