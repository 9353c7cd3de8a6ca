"""The segmentation cells (traffic kind ``seg_closed_loop``) on the CPU at
their tiny sizes, beyond what the tests over every cell run (a sound run
correct, each fault caught: ``test_bench_check.py``): the program's
backbone against the reference on one state dict, calibrated per-pixel
probabilities that differ between images and pixels, a planted fault
reaching the seg wrapper through ``NBDT.forward``, and the readers that sum
a request's spans of one name (``branches_ms.serve``, ``fuse_ms.serve``)."""

from types import SimpleNamespace

import pytest
import torch

import bench_testlib
from benchmark import cells, faults, harness

SEG = bench_testlib.cells_of_kind("seg_closed_loop")
T0 = 10_000_000_000


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def tiny_context(workload, seed=4):
    _, cell, config = bench_testlib.tiny_cell(workload)
    return harness.Context(workload, cell, config, seed, "cpu")


@pytest.mark.parametrize("workload", SEG)
def test_backbone_matches_the_reference(workload):
    ctx = tiny_context(workload)
    ref, program = ctx.reference(), ctx.program_model().eval()
    x = ctx.images(2, "probe").permute(0, 3, 1, 2)
    with torch.no_grad():
        want = ref(x)
        got = program(x.contiguous(memory_format=torch.channels_last))
    rows = got.permute(0, 2, 3, 1).reshape(-1, got.shape[1])
    torch.testing.assert_close(rows, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("workload", SEG)
def test_calibrated_pixel_probabilities_differ(workload):
    """Between the images of a request and between the pixels of one image:
    a check against them can see a pixel or an image moved."""
    kind = harness.load_module(cells.BENCH / "traffic" / "seg_closed_loop.py")
    ctx = tiny_context(workload)
    probs = kind.SegReferenceServe(ctx.reference(), ctx.rules(), tf32=False)(
        ctx.images(2, "probe"))
    n, h, w, c = probs.shape
    assert (n, c) == (2, ctx.config["model"]["num_classes"]) and h == w > 1
    torch.testing.assert_close(probs.sum(-1), torch.ones(n, h, w))
    assert (probs[0] - probs[1]).abs().amax(-1).mean() > 0.1
    assert (probs[0] - probs[0].roll(h // 2, 0)).abs().amax(-1).mean() > 0.1
    assert probs.amax(-1).mean() < 0.9, "no class takes every pixel"


@pytest.mark.parametrize("workload", SEG)
def test_planted_fault_reaches_the_seg_wrapper(workload):
    from nbdt_torch.model import SoftSegNBDT

    ctx = tiny_context(workload)
    seg = SoftSegNBDT(ctx.config["tree"]["dataset"], ctx.program_model(),
                      tree=ctx.program_tree(), device="cpu")
    x = ctx.images(2, "probe")
    sound = seg(x)
    with faults.plant("answer_altered"):
        altered = seg(x)
    assert (altered[0] - sound[0]).abs().max() > 0.1
    torch.testing.assert_close(altered[1], sound[1], rtol=0, atol=0)


def record(name, group, device_ms, start_s):
    return {"name": name, "id": 0, "parent": None, "group": group, "attrs": {},
            "start_ns": T0 + int(start_s * 1e9), "end_ns": T0 + int(start_s * 1e9) + 1,
            "device": "cuda", "device_ms": device_ms, "device_start_ms": 0.0,
            "device_end_ms": device_ms}


# three requests (groups 1, 2, 3): branches 10+20+30, 5+5, 40; fuse 1+2, 3, none
SPANS = [record("branches", 1, 10.0, 0.1), record("fuse", 1, 1.0, 0.11),
         record("branches", 1, 20.0, 0.12), record("fuse", 1, 2.0, 0.13),
         record("branches", 1, 30.0, 0.14),
         record("branches", 2, 5.0, 0.3), record("branches", 2, 5.0, 0.31),
         record("fuse", 2, 3.0, 0.32),
         record("branches", 3, 40.0, 0.5),
         record("branches", 4, 99.0, 2.0)]  # after the window


def fake_run(variant="program"):
    return SimpleNamespace(context=SimpleNamespace(variant=variant), t0_ns=T0,
                           t1_ns=T0 + int(1e9), setup_s=1.0)


@pytest.fixture
def kept(monkeypatch):
    from nbdt_torch import profiling

    def spans(t0_ns=None, t1_ns=None):
        return [s for s in SPANS if (t0_ns is None or s["start_ns"] >= t0_ns)
                and (t1_ns is None or s["start_ns"] < t1_ns)]

    monkeypatch.setattr(profiling, "spans", spans)
    return profiling


def read(metric, run):
    return harness.load_module(cells.BENCH / "metrics" / f"{metric}.py").read(run)


@pytest.mark.parametrize("metric,expected", [("branches_ms.serve", 40.0),  # of 60, 10, 40
                                             ("fuse_ms.serve", 3.0)])  # of 3, 3
def test_reader_sums_a_requests_spans(kept, metric, expected):
    assert read(metric, fake_run()) == pytest.approx(expected)


@pytest.mark.parametrize("metric", ["branches_ms.serve", "fuse_ms.serve"])
@pytest.mark.parametrize("case", ["control", "no spans", "no span store"])
def test_reader_gives_none_with_nothing_to_read(kept, monkeypatch, metric, case):
    if case == "no spans":
        monkeypatch.setattr(kept, "spans", lambda t0_ns=None, t1_ns=None: [])
    elif case == "no span store":
        monkeypatch.delattr(kept, "spans")
    assert read(metric, fake_run("control" if case == "control" else "program")) is None


@pytest.mark.gpu
@pytest.mark.parametrize("workload", SEG)
def test_request_splits_on_the_card(workload):
    """A traced run: backbone, head and the gap to the next request add up
    to the window's mean request within 2%, and the modules' branches and
    exchange units lie inside the backbone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' device times come from CUDA events")
    result = harness.run_cell(workload, 20261018, 4, True, keep_facts=True,
                              spec=bench_testlib.SPEC)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    period = 1000 * result["facts"]["window_s"] / result["facts"]["requests"]
    total = m["backbone_ms.serve"] + m["head_ms.serve"] + m["request_gap_ms.serve"]
    assert abs(total - period) <= 0.02 * period, (m, period)
    assert 0 < m["branches_ms.serve"] + m["fuse_ms.serve"] < m["backbone_ms.serve"]
    assert result["correct"], result["checks"]
