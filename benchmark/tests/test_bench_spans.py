"""The readers of the program's spans (``program_spans.py`` and the
``metrics/*`` that use it) on a fake run holding hand-made span records:
each gives the median or the union it defines, and None with no spans, on
the control variant and for a program that keeps no spans. On the card
(marked ``gpu``), a traced run's request splits into its backbone, its head
and the gap to the next request."""

from types import SimpleNamespace

import pytest
import torch

import bench_testlib  # noqa: F401  (puts the checkout on sys.path)
from benchmark import harness

T0 = 10_000_000_000  # the window's start, ns
SERVE = ["resnet18_cifar10.offline", "vit_b16_imagenet1000.offline"]


def record(name, start_s, end_s, device_ms=None, device_start_ms=None):
    """A span as ``nbdt_torch.profiling.spans`` gives it: host times in
    seconds from the window's start, device times in ms from an origin."""
    timed = device_ms is not None
    return {"name": name, "id": 0, "parent": None, "group": 0, "attrs": {},
            "start_ns": T0 + int(start_s * 1e9), "end_ns": T0 + int(end_s * 1e9),
            "device": "cuda" if timed else None, "device_ms": device_ms,
            "device_start_ms": device_start_ms if timed else None,
            "device_end_ms": device_start_ms + device_ms if timed else None}


SET_UP = [  # set-up from -12.5 s (10 s before the last end): union 2.0 s, first calls 1.5 s
    record("tree", -20.0, -19.0),  # an earlier run's
    record("tree", -9.0, -8.75),
    record("nbdt_init", -8.8, -8.5),  # overlaps the tree
    record("first_call", -5.0, -4.0),
    record("kernel_load", -4.5, -4.2),  # inside the first call
    record("first_call", -3.0, -2.5),
    record("request", -2.0, -1.9, 5.0, 0.0),  # a warm-up request, not a set-up span
]
WINDOW = [  # requests at device 0, 10, 25 and 33 ms; heads 1, 3, 2, 2 ms
    record("request", 0.1, 0.2, 8.0, 0.0), record("backbone", 0.1, 0.15, 7.0, 0.0),
    record("head", 0.15, 0.2, 1.0, 7.0),
    record("request", 0.3, 0.4, 12.0, 10.0), record("backbone", 0.3, 0.35, 9.0, 10.0),
    record("head", 0.35, 0.4, 3.0, 19.0),
    record("request", 0.5, 0.6, 6.0, 25.0), record("backbone", 0.5, 0.55, 4.0, 25.0),
    record("head", 0.55, 0.6, 2.0, 29.0),
    record("request", 0.7, 0.8, 7.0, 33.0), record("backbone", 0.7, 0.75, 5.0, 33.0),
    record("head", 0.75, 0.8, 2.0, 38.0),
    record("step", 0.8, 0.85, 4.0, 50.0), record("input", 0.8, 0.81, 0.5, 50.0),
    record("step", 0.85, 0.9, 6.0, 54.5), record("input", 0.85, 0.86, 0.25, 54.5),
    record("step", 0.9, 0.95, 5.0, 62.5), record("input", 0.9, 0.91, 1.0, 62.5),
]
AFTER = [record("request", 2.0, 2.1, 100.0, 500.0)]  # after the window's end

EXPECTED = {
    "backbone_ms.serve": 6.0,  # median of 7, 9, 4, 5
    "head_ms.serve": 2.0,  # of 1, 3, 2, 2
    "request_gap_ms.serve": 2.0,  # 10-8, 25-22, 33-31
    "input_ms.train": 0.5,
    "step_gap_ms.train": 1.25,  # of 54.5-54, 62.5-60.5
    "program_setup_s.setup": 2.0,  # [-9, -8.5], [-5, -4], [-3, -2.5]
    "first_call_s.setup": 1.5,
}
ABSENT = ["forward_ms.train", "loss_ms.train", "backward_ms.train", "optimizer_ms.train"]


def fake_run(variant="program", profiler_start_s=0.0):
    """A run whose set-up took 10 s and ended at T0 - 2.5 s (the last
    ``first_call``'s end), and whose window starts ``profiler_start_s`` after
    T0 (a traced run starts its profiler between the two)."""
    t0 = T0 + int(profiler_start_s * 1e9)
    return SimpleNamespace(context=SimpleNamespace(variant=variant), t0_ns=t0,
                           t1_ns=t0 + int(1e9), setup_s=10.0)


@pytest.fixture
def kept(monkeypatch):
    """The program's span store, holding the records above."""
    from nbdt_torch import profiling

    def spans(t0_ns=None, t1_ns=None):
        return [s for s in SET_UP + WINDOW + AFTER
                if (t0_ns is None or s["start_ns"] >= t0_ns)
                and (t1_ns is None or s["start_ns"] < t1_ns)]

    monkeypatch.setattr(profiling, "spans", spans)
    return profiling


def read(metric, run):
    return harness.load_module(harness.BENCH / "metrics" / f"{metric}.py").read(run)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_gives_its_median_or_union(kept, metric):
    assert read(metric, fake_run()) == pytest.approx(EXPECTED[metric], abs=1e-6)


@pytest.mark.parametrize("metric", ["program_setup_s.setup", "first_call_s.setup"])
def test_set_up_is_read_across_the_profilers_start(kept, metric):
    """A profiler that takes 8 s to start moves the window, not the set-up."""
    assert read(metric, fake_run(profiler_start_s=8.0)) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", ABSENT)
def test_reader_of_a_span_the_run_lacks_gives_none(kept, metric):
    assert read(metric, fake_run()) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED) + ABSENT)
@pytest.mark.parametrize("case", ["control", "no spans", "no span store"])
def test_reader_gives_none_with_nothing_to_read(kept, monkeypatch, metric, case):
    if case == "no spans":
        monkeypatch.setattr(kept, "spans", lambda t0_ns=None, t1_ns=None: [])
    elif case == "no span store":  # a program from before the spans
        monkeypatch.delattr(kept, "spans")
    assert read(metric, fake_run("control" if case == "control" else "program")) is None


def test_every_span_reader_is_in_the_benchmark():
    spec = harness.load_json(bench_testlib.ROOT / "BENCHMARK.json")
    names = {m["name"] for m in spec["per_layer"] if m["source"] == "program_span"}
    assert names == set(EXPECTED) | set(ABSENT)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' device times come from CUDA events")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", SERVE)
def test_request_splits_into_backbone_head_and_gap_on_the_card(card, workload):
    """A traced run: the medians of backbone, head and the gap to the next
    request add up to the window's mean request within 2%."""
    result = harness.run_cell(workload, 20261018, 4, True, keep_facts=True,
                              spec=harness.load_json(bench_testlib.ROOT / "BENCHMARK.json"))
    m = {k: v["value"] for k, v in result["metrics"].items()}
    period = 1000 * result["facts"]["window_s"] / result["facts"]["requests"]
    total = m["backbone_ms.serve"] + m["head_ms.serve"] + m["request_gap_ms.serve"]
    assert abs(total - period) <= 0.02 * period, (m, period)
    assert result["correct"], result["checks"]
