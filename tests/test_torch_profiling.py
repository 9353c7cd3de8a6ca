"""nbdt_torch.profiling against nbdt_tpu.profiling: the step timer on one
clock, and a torch.profiler trace on the CPU; the port's spans: off without
a profiler, their ids, clock and nesting under one, where the program opens
them, the buffer's bound, and their CUDA events resolved on read (a
stand-in for ``torch.cuda.Event`` on the CPU)."""

import json

import pytest
import torch

from test_torch_port import grouped_tree, torch_threads  # noqa: F401  (autouse)


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


class FakeEvent:
    """``torch.cuda.Event`` on the CPU: recorded at a clock that advances by
    1 ms a record; ``elapsed_time`` as the CUDA one."""

    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.at = None

    def record(self, stream=None):
        FakeEvent.clock += 1.0
        self.at = FakeEvent.clock

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def buffer(monkeypatch):
    """A fresh span buffer, and CUDA events that run on the CPU."""
    from nbdt_torch import profiling

    fresh = profiling.SpanBuffer()
    monkeypatch.setattr(profiling, "_BUFFER", fresh)
    monkeypatch.setattr(FakeEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return fresh


@pytest.fixture
def recording():
    """A torch.profiler session on the CPU, as the spans see one."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield prof


@pytest.mark.parametrize("always", [False, True])
def test_span_without_a_profiler_records_only_set_up_spans(buffer, always):
    """No profiler: a layer span records nothing and makes no CUDA event;
    a set-up span (``always``) records its host times, and no event."""
    from nbdt_torch.profiling import span, spans

    with span("request", "cuda", always=always, rows=3):
        with span("backbone", "cuda"):
            pass
    assert FakeEvent.made == 0
    got = spans()
    assert [s["name"] for s in got] == (["request"] if always else [])
    if always:
        assert got[0]["attrs"] == {"rows": 3} and got[0]["device_ms"] is None


def test_nested_spans_carry_parent_group_and_nesting_stamps(buffer, recording):
    """Under a profiler: each span's parent, the root's id as the group of
    all its spans, host stamps that nest, two events a CUDA span resolved to
    device times that nest too."""
    import time

    from nbdt_torch.profiling import span, spans

    t0 = time.time_ns()
    for _ in range(2):
        with span("request", "cuda", rows=4):
            with span("backbone", "cuda"):
                pass
            with span("head", "cuda"):
                with span("inner"):
                    pass
    assert FakeEvent.made == 6 * 2
    got = spans(t0)
    assert [s["name"] for s in got] == ["request", "backbone", "head", "inner"] * 2
    by_id = {s["id"]: s for s in got}
    for k in (0, 4):
        req, back, head, inner = got[k:k + 4]
        assert req["parent"] is None and req["group"] == req["id"]
        assert back["parent"] == head["parent"] == req["id"] and inner["parent"] == head["id"]
        assert {s["group"] for s in got[k:k + 4]} == {req["id"]}
        for child in (back, head, inner):
            parent = by_id[child["parent"]]
            assert parent["start_ns"] <= child["start_ns"] <= child["end_ns"] <= parent["end_ns"]
        assert back["end_ns"] <= head["start_ns"]
        assert req["device_start_ms"] < back["device_start_ms"] < back["device_end_ms"] \
            < head["device_start_ms"] < head["device_end_ms"] < req["device_end_ms"]
        for s in (req, back, head):
            assert s["device_ms"] == s["device_end_ms"] - s["device_start_ms"] > 0
        assert inner["device_ms"] is None and inner["device"] is None
    assert got[4]["device_start_ms"] > got[0]["device_end_ms"]  # one origin a device
    assert spans(t0, got[4]["start_ns"]) == got[:4]


def test_span_names_are_in_the_trace(tmp_path, buffer):
    """``trace``'s Perfetto file holds each span as a ``record_function``."""
    from nbdt_torch.profiling import span, trace

    with trace(str(tmp_path)):
        with span("step", rows=2):
            with span("input"):
                torch.ones(8).sum()
            with span("loss"):
                torch.ones(8).sum()
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"step", "input", "loss"} <= names


def test_spans_record_on_the_profilers_clock(buffer):
    """A span's ``record_function`` event starts inside its host stamps."""
    from nbdt_torch.profiling import span, spans

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("request"):
            torch.ones(4).sum()
    (s,) = spans()
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "request"]
    assert s["start_ns"] <= event.start_ns() <= s["end_ns"]


@pytest.mark.parametrize("capacity,opened", [(4, 3), (4, 4), (4, 11), (1, 5)])
def test_buffer_keeps_the_last_records_and_counts_the_drops(monkeypatch, capacity, opened):
    from nbdt_torch import profiling

    fresh = profiling.SpanBuffer(capacity)
    monkeypatch.setattr(profiling, "_BUFFER", fresh)
    for i in range(opened):
        with profiling.span("tree", always=True, i=i):
            pass
    got = profiling.spans()
    assert [s["attrs"]["i"] for s in got] == list(range(max(0, opened - capacity), opened))
    assert fresh.dropped == max(0, opened - capacity)
    fresh.clear()
    assert profiling.spans() == [] and fresh.dropped == 0


@pytest.mark.parametrize("built", [False, True])
def test_kernel_load_span_says_whether_nvcc_ran(buffer, monkeypatch, built):
    from nbdt_torch.ops import _build
    from nbdt_torch.profiling import spans

    monkeypatch.setattr(_build, "_libraries", {})
    monkeypatch.setattr(_build, "build_all", lambda: built)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    lib = _build.load_library("soft_head")
    _build.load_library("soft_head")  # loaded once: one span
    assert lib[0] == "lib"
    (s,) = spans()
    assert s["name"] == "kernel_load" and s["attrs"] == {"kernel": "soft_head", "built": built}


def _soft_nbdt(fused):
    from nbdt_torch.model import SoftNBDT
    from nbdt_torch.models import ResNet10

    torch.manual_seed(0)
    return SoftNBDT("CIFAR10", ResNet10(10), tree=grouped_tree(10, 3), fused=fused,
                    device="cpu")


@pytest.mark.parametrize("fused", [True, False])
def test_nbdt_forward_records_request_backbone_head(buffer, fused):
    """Set-up spans with no profiler: ``tree`` (the tree is built before
    the wrapper), ``nbdt_init``, then ``first_call`` around the first
    forward alone; under a profiler each request is ``request`` >
    ``backbone``, ``head``, with one group."""
    from nbdt_torch.profiling import spans

    net = _soft_nbdt(fused)
    x = torch.randn(3, 16, 16, 3)
    net(x)
    net(x)
    assert [s["name"] for s in spans()] == ["tree", "nbdt_init", "first_call"]
    buffer.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            net(x)
    got = spans()
    assert [s["name"] for s in got] == ["request", "backbone", "head"] * 2
    for k in (0, 3):
        req, back, head = got[k:k + 3]
        assert req["attrs"] == {"rows": 3} and back["attrs"] == {}
        assert head["attrs"] == {"rows": 3}
        assert back["parent"] == head["parent"] == req["id"]
        assert back["group"] == head["group"] == req["group"] == req["id"]
        assert req["start_ns"] <= back["start_ns"] <= back["end_ns"] <= head["start_ns"] \
            <= head["end_ns"] <= req["end_ns"]
    assert got[0]["group"] != got[3]["group"]


def _train_step(cached):
    from nbdt_torch.models import ResNet10
    from nbdt_torch.rules import to_device_tree
    from nbdt_torch.trainer import TrainConfig, lr_schedule, make_optimizer, make_train_step

    torch.manual_seed(0)
    model = ResNet10(10).to(memory_format=torch.channels_last)
    cfg = TrainConfig(batch_size=4, epochs=2)
    jt = to_device_tree(grouped_tree(10, 3).arrays, "cpu")
    step = make_train_step(model, make_optimizer(cfg, model.parameters()), lr_schedule(cfg, 2),
                           "SoftTreeSupLoss", jt, normalize=((0.5,) * 3, (0.25,) * 3),
                           cached=cached, batch_size=4, crop_pad=2, steps_per_call=2)
    images = torch.randint(0, 256, (8, 16, 16, 3), dtype=torch.uint8)
    labels = torch.randint(0, 10, (8,))
    if cached:
        perm, gen = torch.randperm(8), torch.Generator().manual_seed(0)
        return lambda: step(images, labels, perm, 0, gen, 1.0, 1.0, 0), 2
    return lambda: step(images[:4], labels[:4], 1.0, 1.0, 0), 1


@pytest.mark.parametrize("cached", [True, False])
def test_train_step_records_its_layers_in_order(buffer, cached):
    """The step function's first call is ``first_call``; under a profiler
    each optimizer step is ``step`` > ``input``, ``forward``, ``loss``,
    ``backward``, ``optimizer``, one after the other."""
    from nbdt_torch.profiling import spans

    call, steps = _train_step(cached)
    call()
    assert [s["name"] for s in spans()][-1:] == ["first_call"]
    buffer.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        call()
    got = spans()
    layers = ["input", "forward", "loss", "backward", "optimizer"]
    assert [s["name"] for s in got] == (["step"] + layers) * steps
    for k in range(0, len(got), 6):
        step, children = got[k], got[k + 1:k + 6]
        assert step["attrs"] == {"rows": 4} and step["parent"] is None
        assert all(c["parent"] == step["id"] and c["group"] == step["id"] for c in children)
        stamps = [t for c in children for t in (c["start_ns"], c["end_ns"])]
        assert stamps == sorted(stamps)
        assert step["start_ns"] <= stamps[0] and stamps[-1] <= step["end_ns"]
