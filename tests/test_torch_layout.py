"""The backbone's memory layout on the inference entries
(``nbdt_torch/models/layout.py``): the rule as a pure function of device
type, conv dtype and cuDNN's TF32 switch; on the CPU every entry gives the
channels-last outputs it always gave, bit for bit, with channels-last
weights; the NCHW half of each entry, forced on the CPU, against the
channels-last one; the backbone's input in the placed format through each
wrapper; and on a card, an f32 ResNet18 with TF32 off placed and fed in
contiguous NCHW, with no layout transpose among its kernels. ``timed_conv_engines``: cuDNN's benchmark flag
on under the same rule, every other flag kept inside and all restored."""

import contextlib
import copy

import pytest
import torch

from test_torch_port import grouped_tree
from test_torch_port import torch_threads  # noqa: F401  (autouse)

NCHW, CL = torch.contiguous_format, torch.channels_last
IMG = 16


@pytest.mark.parametrize("device_type, dtype, allow_tf32, want", [
    ("cuda", torch.float32, False, NCHW),
    ("cuda", torch.float32, True, CL),
    ("cuda", torch.bfloat16, False, CL),
    ("cuda", torch.bfloat16, True, CL),
    ("cuda", torch.float16, False, CL),
    ("cuda", None, False, CL),
    ("cpu", torch.float32, False, CL),
    ("cpu", torch.float32, True, CL),
    ("cpu", torch.bfloat16, False, CL),
])
def test_conv_memory_format_rule(device_type, dtype, allow_tf32, want):
    from nbdt_torch.models.layout import conv_memory_format

    assert conv_memory_format(device_type, dtype, allow_tf32) == want


def _weights_in(module, fmt):
    weights = [p for p in module.parameters() if p.dim() == 4]
    assert weights
    return all(p.is_contiguous(memory_format=fmt) for p in weights)


@pytest.mark.parametrize("allow_tf32", [False, True])
def test_place_backbone_on_the_cpu_keeps_channels_last(monkeypatch, allow_tf32):
    """Either TF32 setting: channels-last weights, eval mode; a backbone
    without a conv places as channels-last too."""
    from nbdt_torch.models import ResNet10
    from nbdt_torch.models.layout import place_backbone

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", allow_tf32)
    model, fmt = place_backbone(ResNet10(10).train(), "cpu")
    assert fmt == CL and not model.training and _weights_in(model, CL)
    linear, fmt = place_backbone(torch.nn.Linear(4, 2), torch.device("cpu"))
    assert fmt == CL and not linear.training


@pytest.fixture(scope="module")
def parts():
    from nbdt_torch.models import ResNet10
    from nbdt_torch.models.segnet import SegNet

    torch.manual_seed(0)
    return {"resnet": ResNet10(10).eval(), "segnet": SegNet(10).eval(),
            "tree": grouped_tree(10, 3),
            "x": torch.randn(5, IMG, IMG, 3, generator=torch.Generator().manual_seed(1))}


ENTRIES = ("HardNBDT", "SoftNBDT(fused=True)", "SoftSegNBDT", "make_eval_fn",
           "make_serving_fn f32")


def _entry(parts, name):
    """One inference entry on the CPU as ``(placed module, call,
    committed)``, built on a copy of the fixture's module (placement moves
    a module in place): ``committed`` is the forward the entry ran before
    the layout rule, by hand (a channels-last copy of the module, the NHWC
    view)."""
    from nbdt_torch import HardNBDT, SoftNBDT
    from nbdt_torch.model import SoftSegNBDT, TaggedOutput
    from nbdt_torch.models import make_eval_fn
    from nbdt_torch.ops.soft_traversal import fused_soft_head
    from nbdt_torch.rules import soft_forward, to_device_tree
    from nbdt_torch.serving import make_serving_fn
    from nbdt_torch.utils import coerce_tensor, uncoerce_tensor

    tree = parts["tree"]
    module = copy.deepcopy(parts["segnet" if name == "SoftSegNBDT" else "resnet"])

    def committed(head):
        ref = copy.deepcopy(module).to(memory_format=CL).eval()
        return lambda x: head(ref, x.permute(0, 3, 1, 2))

    if name == "HardNBDT":
        hard = HardNBDT("CIFAR10", module, tree=tree, device="cpu")
        return hard.model, hard, committed(lambda m, v: hard.rules(m(v)))
    if name == "SoftNBDT(fused=True)":
        fused = SoftNBDT("CIFAR10", module, tree=tree, fused=True, device="cpu")
        return fused.model, fused, committed(lambda m, v: torch.exp(
            fused_soft_head(m(v, features_only=True), fused._head, want_aux=False)[0]))
    if name == "SoftSegNBDT":
        seg = SoftSegNBDT(None, module, tree=tree, device="cpu")

        def seg_head(m, v):
            maps = m(v).permute(0, 2, 3, 1)
            return TaggedOutput(uncoerce_tensor(seg.rules(coerce_tensor(maps)), maps.shape))

        return seg.model, seg, committed(seg_head)
    if name == "make_eval_fn":
        return module, make_eval_fn(module, device="cpu"), committed(lambda m, v: m(v))
    jt = to_device_tree(tree.arrays, "cpu")
    return module, make_serving_fn(module, tree, bf16=False, device="cpu"), committed(
        lambda m, v: soft_forward(m(v).float(), jt))


def _inputs_seen(module):
    """The backbone inputs ``module`` is called with, recorded by a hook."""
    seen = []
    module.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    return seen


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_on_the_cpu_matches_the_channels_last_forward(parts, name):
    """The CPU keeps channels-last: the entry's output equals, bit for bit,
    the channels-last forward it ran before the rule, and its backbone got
    the NHWC input as a view."""
    module, call, committed = _entry(parts, name)
    assert _weights_in(module, CL)
    seen = _inputs_seen(module)
    with torch.no_grad():
        got, want = call(parts["x"]), committed(parts["x"])
    assert torch.equal(got, want)
    (x,) = seen
    assert x.is_contiguous(memory_format=CL) and not x.is_contiguous()


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_in_nchw_matches_channels_last(parts, monkeypatch, name):
    """The NCHW half of the entry, forced on the CPU (the rule patched to
    answer NCHW): contiguous weights, a contiguous backbone input, and the
    channels-last output within f32 rounding."""
    from nbdt_torch.models import layout

    monkeypatch.setattr(layout, "conv_memory_format", lambda *args: NCHW)
    module, call, committed = _entry(parts, name)
    assert _weights_in(module, NCHW)
    seen = _inputs_seen(module)
    with torch.no_grad():
        got, want = call(parts["x"]), committed(parts["x"])
    (x,) = seen
    assert x.is_contiguous()
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("nchw", [False, True], ids=["channels_last", "nchw"])
def test_backbone_gets_its_input_in_the_placed_format(parts, monkeypatch, nchw):
    """``SoftNBDT`` fused and plain and ``SoftSegNBDT`` call their backbone
    with its input in the format ``place_backbone`` gave the wrapper
    (``_format``), and not in the other: channels-last as the CPU is, NCHW
    with the rule patched to answer it."""
    from nbdt_torch import SoftNBDT
    from nbdt_torch.model import SoftSegNBDT
    from nbdt_torch.models import layout

    want, other = (NCHW, CL) if nchw else (CL, NCHW)
    if nchw:
        monkeypatch.setattr(layout, "conv_memory_format", lambda *args: NCHW)
    tree = parts["tree"]
    wrappers = [
        SoftNBDT("CIFAR10", copy.deepcopy(parts["resnet"]), tree=tree, fused=True, device="cpu"),
        SoftNBDT("CIFAR10", copy.deepcopy(parts["resnet"]), tree=tree, device="cpu"),
        SoftSegNBDT(None, copy.deepcopy(parts["segnet"]), tree=tree, device="cpu"),
    ]
    for net in wrappers:
        assert net._format == want
        seen = _inputs_seen(net.model)
        with torch.no_grad():
            net(parts["x"])
        (x,) = seen
        assert x.is_contiguous(memory_format=want) and not x.is_contiguous(memory_format=other)


@pytest.mark.gpu
def test_f32_resnet18_serves_in_nchw_on_gpu():
    """SoftNBDT(fused=True) over an f32 ResNet18 at batch 512, TF32 off:
    contiguous weights and input, the channels-last wrapper's leaves (the
    same backbone placed with TF32 on, run with it off) within the fused
    head's GPU tolerances, and no NHWC<->NCHW transpose in a CUDA trace of
    one request."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from nbdt_torch import SoftNBDT
    from nbdt_torch.models import ResNet18

    torch.manual_seed(0)
    model = ResNet18(10)
    tree = grouped_tree(10, 3)
    x = torch.randn(512, 32, 32, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        channels_last = SoftNBDT("CIFAR10", model, tree=tree, fused=True)
        assert _weights_in(channels_last.model, CL)
        torch.backends.cudnn.allow_tf32 = False
        want = channels_last(x).clone()
        net = SoftNBDT("CIFAR10", copy.deepcopy(model), tree=tree, fused=True)
        assert _weights_in(net.model, NCHW)
        assert net._input(x).is_contiguous()
        got = net(x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)

        def kernels(wrapper):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wrapper(x)
                torch.cuda.synchronize()
            return [e.key for e in prof.key_averages() if e.device_time_total > 0]

        names, before = kernels(net), kernels(channels_last)
        print("channels-last transposes:", [k for k in before if "To" in k and "Kernel" in k])
        assert any("soft_head" in k for k in names), names
        assert not [k for k in names if "nhwcToNchw" in k or "nchwToNhwc" in k], names
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _cudnn_flags():
    """Every flag ``torch.backends.cudnn.flags`` takes, at its value now."""
    import inspect

    cudnn = torch.backends.cudnn
    return {name: getattr(cudnn, name) for name in inspect.signature(cudnn.flags).parameters}


def _input_on(device_type, dtype):
    """What ``timed_conv_engines`` reads of its input, on any device."""
    from types import SimpleNamespace

    return SimpleNamespace(device=torch.device(device_type), dtype=dtype)


@pytest.mark.parametrize("device_type, dtype, allow_tf32, timed", [
    ("cuda", torch.float32, False, True),
    ("cuda", torch.float32, True, False),
    ("cuda", torch.bfloat16, False, False),
    ("cuda", torch.float16, False, False),
    ("cpu", torch.float32, False, False),
    ("cpu", torch.float32, True, False),
    ("cpu", torch.bfloat16, False, False),
])
def test_timed_conv_engines_follows_the_layout_rule(monkeypatch, device_type, dtype, allow_tf32,
                                                    timed):
    """cuDNN's benchmark flag is on inside the context only where the layout
    rule gives NCHW (CUDA, f32, TF32 off); elsewhere nothing changes."""
    from nbdt_torch.models.layout import timed_conv_engines

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    before = _cudnn_flags()
    with timed_conv_engines(_input_on(device_type, dtype)) as applies:
        inside = _cudnn_flags()
    assert applies == timed
    assert inside == ({**before, "benchmark": True} if timed else before)


@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
@pytest.mark.parametrize("applies", [False, True], ids=["heuristic", "timed"])
def test_timed_conv_engines_restores_every_cudnn_flag(monkeypatch, applies, raises):
    from nbdt_torch.models.layout import timed_conv_engines

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    before = _cudnn_flags()
    x = _input_on("cuda" if applies else "cpu", torch.float32)
    with pytest.raises(RuntimeError) if raises else contextlib.nullcontext():
        with timed_conv_engines(x) as timed:
            assert timed == applies
            if raises:
                raise RuntimeError("inside the context")
    assert _cudnn_flags() == before


@pytest.mark.parametrize("allow_tf32", [False, True])
def test_timed_conv_engines_keeps_cudnn_and_tf32_as_they_are(monkeypatch, allow_tf32):
    """Where it applies (the rule patched to answer NCHW, so a CPU tensor
    stands for a CUDA one), only ``benchmark`` changes inside the context:
    ``flags``' own defaults would turn cuDNN off and TF32 on."""
    from nbdt_torch.models import layout

    monkeypatch.setattr(layout, "conv_memory_format", lambda *args: NCHW)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "enabled", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    with layout.timed_conv_engines(torch.zeros(1, 1, 2, 2)) as timed:
        assert timed
        assert torch.backends.cudnn.enabled
        assert torch.backends.cudnn.allow_tf32 == allow_tf32
        assert torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.benchmark
