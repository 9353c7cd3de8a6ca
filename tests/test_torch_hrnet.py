"""HRNetV2 (``nbdt_torch/models/hrnet.py``) against the benchmark's plain
reference (``benchmark/reference/hrnet.py``) on the CPU: a tiny HRNetV2 on
one seeded state dict at even and odd sizes, ``align_corners`` both ways;
the W48 widths' parameter count and output shape on the meta device;
``SoftSegNBDT`` over the tiny model on the vendored ADE20K tree; the
spans of the seg path under a ``torch.profiler`` session (host times);
which layers run with cuDNN's benchmark flag; that calls keep no state in
the model; and on a card, the branch blocks' timed cuDNN engines against
the heuristic ones."""

import copy
import math
import sys
from pathlib import Path

import pytest
import torch

from test_torch_port import torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.reference import hrnet as reference  # noqa: E402
from benchmark.reference.tree import DATA, Hierarchy, SoftRules  # noqa: E402

TINY = {"widths": (4, 8, 16, 32), "blocks": 1, "modules": (1, 1, 1), "stem_width": 8}
ADE20K_GRAPH = DATA / "ADE20K.graph-induced-HRNet-w48.json"
ADE20K_WNIDS = DATA / "ADE20K.wnids.txt"


def seeded_state(model, seed):
    """A state dict for ``model``'s keys: convs N(0, 1/fan_in), BatchNorm
    scales and variances U(0.5, 1.5), means and biases N(0, 0.1^2)."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, like in model.state_dict().items():
        if not like.is_floating_point():
            state[key] = like.clone()
        elif key.endswith("running_var") or (like.dim() == 1 and key.endswith("weight")):
            state[key] = 0.5 + torch.rand(like.shape, generator=gen)
        elif like.dim() == 1:
            state[key] = 0.1 * torch.randn(like.shape, generator=gen)
        else:
            state[key] = torch.randn(like.shape, generator=gen) / math.sqrt(like[0].numel())
    return state


def tiny_pair(align_corners=True, num_classes=150, seed=0):
    """(the port's tiny HRNetV2, the reference), both in eval mode on one
    seeded state dict."""
    from nbdt_torch.models import HRNetV2

    ref = reference.HRNetV2(num_classes, align_corners=align_corners, **TINY).eval()
    port = HRNetV2(num_classes, align_corners=align_corners, **TINY).eval()
    state = seeded_state(ref, seed)
    ref.load_state_dict(state, strict=True)
    port.load_state_dict(state, strict=True)
    return port, ref


def images(n, h, w, seed=1):
    return torch.randn(n, 3, h, w, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [(32, 32), (64, 64), (45, 37)])
def test_tiny_hrnet_matches_the_reference(align_corners, size):
    """Odd sides give odd branch sizes (45 -> 12, 6, 3, 2 rows at strides 4
    to 32), where the exchange units' upsampling meets sizes that are not
    a power of two apart."""
    port, ref = tiny_pair(align_corners)
    x = images(2, *size)
    with torch.no_grad():
        got = port(x)
        want = ref(x)
    h, w = ((s - 1) // 2 // 2 + 1 for s in size)
    assert got.shape == (2, 150, h, w)
    assert want.shape == (2 * h * w, 150)
    rows = got.permute(0, 2, 3, 1).reshape(-1, 150)
    assert rows.std(0).mean() > 0.1, "the logits differ between pixels"
    torch.testing.assert_close(rows, want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():  # the layout the NBDT wrappers give it on the CPU
        last = port(x.contiguous(memory_format=torch.channels_last))
    torch.testing.assert_close(last.permute(0, 2, 3, 1).reshape(-1, 150), want,
                               rtol=1e-5, atol=1e-5)


def test_align_corners_changes_the_answer():
    port, _ = tiny_pair(True)
    other, _ = tiny_pair(False)
    x = images(1, 32, 32)
    with torch.no_grad():
        assert (port(x) - other(x)).abs().max() > 1e-3


def test_w48_sizes_on_the_meta_device():
    """HRNetV2-W48 for ADE20K: 65.95 M parameters (the paper's 65.9 M), the
    reference's keys, and ``[1, 150, 130, 130]`` at 520x520."""
    from nbdt_torch.models import hrnetv2_w48

    with torch.device("meta"):
        model = hrnetv2_w48(150)
        ref = reference.HRNetV2(150)
        out = model(torch.empty(1, 3, 520, 520))
    assert sum(p.numel() for p in model.parameters()) == 65_953_830
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    assert out.shape == (1, 150, 130, 130)
    assert model.classifier is model.last_layer[3]
    assert sum(type(m).__name__ == "BasicBlock" for m in model.modules()) == 104
    assert sum(type(m).__name__ == "Bottleneck" for m in model.modules()) == 4


def test_a_stage_count_that_does_not_fit_the_widths_is_refused():
    from nbdt_torch.models import HRNetV2

    with pytest.raises(ValueError, match="stages"):
        HRNetV2(150, widths=(4, 8, 16), modules=(1, 1, 1))


def ade20k_tree():
    from nbdt_torch.tree import Tree

    return Tree("ADE20K", path_graph=str(ADE20K_GRAPH), path_wnids=str(ADE20K_WNIDS))


def test_soft_seg_nbdt_matches_the_reference_rows():
    """``SoftSegNBDT`` over the tiny model: the reference's per-pixel rows
    through the plain soft rules, reshaped to ``[N, h, w, C]``."""
    from nbdt_torch.model import SoftSegNBDT, TaggedOutput

    port, ref = tiny_pair(seed=3)
    x = images(2, 40, 48, seed=4)
    got = SoftSegNBDT("ADE20K", port, tree=ade20k_tree(), device="cpu")(x.permute(0, 2, 3, 1))
    rules = SoftRules(Hierarchy(ADE20K_GRAPH, ADE20K_WNIDS), "cpu")
    with torch.no_grad():
        want = rules.probs(ref(x)).view(2, 10, 12, 150)
    assert isinstance(got, TaggedOutput) and got.shape == (2, 10, 12, 150)
    torch.testing.assert_close(got.sum(-1), torch.ones(2, 10, 12))
    torch.testing.assert_close(got.as_subclass(torch.Tensor), want, rtol=1e-5, atol=1e-5)


def test_seg_path_spans():
    """The first call in ``first_call``; under a profiler each request's
    ``request`` span (images) holds ``backbone`` (one ``branches`` and one
    ``fuse`` span a module, with its stage and index) and ``head`` (pixel
    rows)."""
    import time

    from nbdt_torch import profiling
    from nbdt_torch.model import SoftSegNBDT

    port, _ = tiny_pair()
    seg = SoftSegNBDT("ADE20K", port, tree=ade20k_tree(), device="cpu")
    x = images(2, 32, 32).permute(0, 2, 3, 1)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        seg(x)
        seg(x)
    spans = profiling.spans(t0)
    assert [s["name"] for s in spans].count("first_call") == 1
    requests = [s for s in spans if s["name"] == "request"]
    assert len(requests) == 2 and all(s["attrs"]["rows"] == 2 for s in requests)
    by_id = {s["id"]: s for s in spans}
    for request in requests:
        group = [s for s in spans if s["group"] == request["group"]]
        children = [s for s in group if s["parent"] == request["id"]]
        assert [s["name"] for s in children] == ["backbone", "head"]
        backbone, head = children
        assert head["attrs"]["rows"] == 2 * 8 * 8
        inner = [s for s in group if s["parent"] == backbone["id"]]
        assert [(s["name"], s["attrs"]) for s in inner] == [
            (name, {"stage": stage, "module": 0})
            for stage in (2, 3, 4) for name in ("branches", "fuse")]
        assert all(by_id[s["parent"]]["name"] == "backbone" for s in inner)
        assert all(s["device_ms"] is None for s in group)  # host times on the CPU


@pytest.mark.parametrize("rule", ["nchw", "as_is"])
def test_branch_blocks_run_with_timed_engines_where_the_rule_says(monkeypatch, rule):
    """Forward pre-hooks read cuDNN's benchmark flag as each layer starts:
    on in every branch ``BasicBlock`` where the layout rule gives NCHW (here
    patched, so the CPU stands for a card), off where it does not (the CPU
    as it is), and at the caller's value (off) in the stem, stage 1, the
    transitions, the exchange units and the head; restored afterwards."""
    from nbdt_torch.models import layout
    from nbdt_torch.models.resnet import BasicBlock

    if rule == "nchw":
        monkeypatch.setattr(layout, "conv_memory_format", lambda *args: torch.contiguous_format)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    port, _ = tiny_pair()
    seen = {}
    for name, module in port.named_modules():
        module.register_forward_pre_hook(
            lambda m, args, name=name: seen.setdefault(name, []).append(
                torch.backends.cudnn.benchmark))
    with torch.no_grad():
        port(images(2, 32, 32))
    assert not torch.backends.cudnn.benchmark
    blocks = {name for name, m in port.named_modules()
              if isinstance(m, BasicBlock) and ".branches." in name}
    assert len(blocks) == 9 and blocks <= set(seen)
    for prefix in ("conv1", "layer1.0.conv1", "transition1.0.0", "transition3.3.0.0",
                   "stage2.0.fuse_layers.0.1", "stage4.0.fuse_layers.3.0.2.0", "last_layer.0"):
        assert prefix in seen, prefix
    for name, flags in seen.items():
        timed = rule == "nchw" and ".branches." in name
        assert flags == [timed], name


def test_hrnet_keeps_no_state_between_calls(monkeypatch):
    """With the timing rule answering yes (patched, so the CPU stands for a
    card), calls at three input shapes leave every module's attributes (their
    names, and the values of the public ones) and the state dict as they
    were."""
    from nbdt_torch.models import layout

    monkeypatch.setattr(layout, "conv_memory_format", lambda *args: torch.contiguous_format)
    port, _ = tiny_pair()

    def attributes():
        return {name: (sorted(vars(m)), copy.deepcopy(
            {k: v for k, v in vars(m).items() if not k.startswith("_")}))
            for name, m in port.named_modules()}

    before, state = attributes(), copy.deepcopy(port.state_dict())
    with torch.no_grad():
        for size in ((32, 32), (48, 48), (45, 37)):
            port(images(2, *size))
    assert attributes() == before
    after = port.state_dict()
    assert list(after) == list(state)
    assert all(torch.equal(after[k], v) for k, v in state.items())


@pytest.mark.gpu
def test_timed_branch_engines_on_gpu(monkeypatch):
    """A small HRNetV2 with W48's widths through ``SoftSegNBDT`` in f32, TF32
    off: the branch blocks' timed engines give the heuristic ones' per-pixel
    class probabilities within the seg cell's ``prob_gap`` limit (the
    heuristic path is the helper patched away, run at two images a call so
    that cuDNN's plan cache, keyed by shape, holds its own plans); no TF32
    or tensor-core kernel runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import contextlib
    import json

    from torch.profiler import ProfilerActivity, profile

    from nbdt_torch.model import SoftSegNBDT
    from nbdt_torch.models import HRNetV2, hrnet

    cell = json.loads((REPO / "benchmark/workloads/hrnetv2_w48_ade20k.offline.json").read_text())
    limit = cell["limits"]["prob_gap"]
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        model = HRNetV2(150, widths=(48, 96, 192, 384), blocks=1, modules=(1, 1, 1)).eval()
        model.load_state_dict(seeded_state(model, 5))
        seg = SoftSegNBDT("ADE20K", model, tree=ade20k_tree())
        x = torch.randn(4, 256, 256, 3, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(6))
        seg(x)  # the first call at these shapes times the engines
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = seg(x).as_subclass(torch.Tensor)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if e.device_time_total > 0]

        @contextlib.contextmanager
        def heuristic(x):
            yield False

        monkeypatch.setattr(hrnet, "timed_conv_engines", heuristic)
        want = torch.cat([seg(part).as_subclass(torch.Tensor) for part in x.split(2)])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert float((got - want).abs().max()) < limit
    assert not [k for k in names if any(t in k.lower() for t in ("tf32", "s1688", "hmma", "wgmma"))]
