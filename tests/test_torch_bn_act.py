"""The eval BatchNorm + residual + ReLU pass (``nbdt_torch/ops/bn_act.py``,
``csrc/bn_act.cu``) and its dispatch in ``nbdt_torch/models/resnet.py``.

On the CPU: the plain version against ``nn.BatchNorm2d.eval()`` followed by
the add and ``F.relu`` in each variant, within 1e-6 of the output's largest
magnitude (the two round at other places, and where ``x * s`` and ``t``
cancel a pointwise relative bound means nothing); the wrapper writing over
its input, and its refusals (an offset view among them); the dispatch rule
as a pure function; the CPU outputs of ResNet18 and HRNetV2 bit for bit those of the benchmark's plain
references, which run the library passes in the order the port ran them
before the pass; and, with the rule forced on the CPU (the plain version in
the kernel's place, NCHW placement), the passes one forward takes: 17 for
ResNet18, 49 for resnet50, 220 for HRNetV2's blocks, none for training, a
forward with autograd on, bf16, a folded model, channels-last or an export
trace. On a card: the kernel bit for bit its plain version at both cells'
shapes, on odd and tiny planes; launches per forward; export and its
artifact with none."""

import sys
from pathlib import Path

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from test_torch_port import grouped_tree
from test_torch_port import torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

NCHW = torch.contiguous_format


def _bn(C, seed, device="cpu"):
    """An eval ``BatchNorm2d`` with seeded scales, shifts and statistics."""
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(C).eval()
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(C, generator=g))
        bn.bias.copy_(0.1 * torch.randn(C, generator=g))
        bn.running_mean.copy_(0.5 * torch.randn(C, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(C, generator=g))
    return bn.to(device)


def _case(shape, residual, seed=0, device="cpu"):
    """``(x, bn, r, rbn)`` for a variant: no residual, ``"plain"`` or
    ``"bn"`` (the residual through its own BatchNorm)."""
    g = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(shape, generator=g) + 0.5).to(device)
    r = (2 * torch.randn(shape, generator=g)).to(device) if residual else None
    rbn = _bn(shape[1], seed + 2, device) if residual == "bn" else None
    return x, _bn(shape[1], seed + 1, device), r, rbn


def _library(x, bn, r, rbn):
    """What the port ran before the pass: the library's BatchNorm, add, ReLU."""
    y = bn(x)
    if r is not None:
        y = y + (rbn(r) if rbn is not None else r)
    return F.relu(y)


VARIANTS = (None, "plain", "bn")


@pytest.mark.parametrize("side", [17, 33, 65, 4, 32, 7, 3, 1])
@pytest.mark.parametrize("residual", VARIANTS)
def test_reference_matches_the_library_passes(side, residual):
    from nbdt_torch.ops import bn_act as ba

    x, bn, r, rbn = _case((2, 48, side, side), residual, seed=side)
    with torch.no_grad():
        want = _library(x, bn, r, rbn)
        got = ba.bn_act_reference(x, bn, r, rbn)
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
        before, ptr = ba.launches, x.data_ptr()
        out = ba.fused_bn_act(x, bn, r, rbn)
    assert ba.launches == before  # the CPU takes the plain version
    assert out.data_ptr() == ptr and torch.equal(out, got)  # written over x


def test_bn_act_refusals():
    from nbdt_torch.ops.bn_act import fused_bn_act

    x, bn, r, rbn = _case((2, 8, 5, 5), "bn")
    with pytest.raises(ValueError, match="contiguous NCHW f32"):
        fused_bn_act(x.transpose(2, 3), bn)
    with pytest.raises(ValueError, match="contiguous NCHW f32"):
        fused_bn_act(x.bfloat16(), bn)
    with pytest.raises(ValueError, match="f32 \\[8\\]"):
        fused_bn_act(x, _bn(4, 0))
    with pytest.raises(ValueError, match="without a residual"):
        fused_bn_act(x, bn, None, rbn)
    with pytest.raises(ValueError, match="residual must be"):
        fused_bn_act(x, bn, r[:, :, :4])
    with pytest.raises(ValueError, match="running statistics"):
        fused_bn_act(x, nn.BatchNorm2d(8, track_running_stats=False))
    offset = torch.randn(x.numel() + 1)[1:].view(x.shape)  # contiguous, 4 bytes past 16
    with torch.no_grad():
        for args in ((offset, bn), (x, bn, offset), (x, bn, offset, rbn)):
            with pytest.raises(ValueError, match="16-byte boundary"):
                fused_bn_act(*args)
    with pytest.raises(RuntimeError, match="forward only"):
        fused_bn_act(x, bn)  # autograd on, BatchNorm parameters that want gradients


@pytest.mark.parametrize("device_type, dtype, contiguous, batch_stats, grad, tracing, want", [
    ("cuda", torch.float32, True, False, False, False, True),
    ("cuda", torch.bfloat16, True, False, False, False, False),
    ("cuda", torch.float16, True, False, False, False, False),
    ("cuda", torch.float32, False, False, False, False, False),
    ("cuda", torch.float32, True, True, False, False, False),
    ("cuda", torch.float32, True, False, True, False, False),
    ("cuda", torch.float32, True, False, False, True, False),
    ("cuda", torch.float32, True, True, True, False, False),
    ("cpu", torch.float32, True, False, False, False, False),
    ("cpu", torch.bfloat16, False, False, False, False, False),
    ("meta", torch.float32, True, False, False, False, False),
])
def test_bn_act_rule(device_type, dtype, contiguous, batch_stats, grad, tracing, want):
    from nbdt_torch.models.resnet import bn_act_rule

    assert bn_act_rule(device_type, dtype, contiguous, batch_stats, grad, tracing) is want


def _seeded(model, seed):
    from test_torch_hrnet import seeded_state

    model.load_state_dict(seeded_state(model, seed))
    return model.eval()


def test_cpu_outputs_are_the_library_passes_bit_for_bit():
    """ResNet18 (stage shortcuts with their BatchNorm) and a small HRNetV2 (a
    Bottleneck stage, odd branch sizes) on the CPU equal the benchmark's
    plain references to the bit, in NCHW and, for ResNet18, channels-last."""
    from benchmark.reference import hrnet as ref_hrnet
    from benchmark.reference import resnet as ref_resnet
    from nbdt_torch.models import HRNetV2, ResNet18

    port = _seeded(ResNet18(10), 3)
    ref = ref_resnet.ResNetCifar().eval()
    ref.load_state_dict(port.state_dict())
    x = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(port(x), ref(x))
        cl = torch.channels_last
        x = x.contiguous(memory_format=cl)
        assert torch.equal(port.to(memory_format=cl)(x), ref.to(memory_format=cl)(x))
    sizes = {"widths": (4, 8, 16, 32), "blocks": 2, "modules": (1, 2, 1), "stem_width": 8}
    port = _seeded(HRNetV2(150, **sizes), 4)
    ref = ref_hrnet.HRNetV2(150, **sizes).eval()
    ref.load_state_dict(port.state_dict())
    x = torch.randn(2, 3, 45, 37, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = port(x)
        assert torch.equal(got.permute(0, 2, 3, 1).reshape(-1, 150), ref(x))


@pytest.fixture
def forced(monkeypatch):
    """The rule as on a card for CPU tensors and NCHW placement, so that
    the plain version runs where the kernel would; yields the list that
    collects one entry per pass."""
    from nbdt_torch.models import layout, resnet

    rule, kernel, calls = resnet.bn_act_rule, resnet.fused_bn_act, []

    def as_on_a_card(device_type, *rest):
        return rule("cuda" if device_type == "cpu" else device_type, *rest)

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return kernel(*args, **kwargs)

    monkeypatch.setattr(resnet, "bn_act_rule", as_on_a_card)
    monkeypatch.setattr(resnet, "fused_bn_act", counted)
    monkeypatch.setattr(layout, "conv_memory_format", lambda *a: NCHW)
    yield calls


def _plain(monkeypatch):
    from nbdt_torch.models import resnet

    monkeypatch.setattr(resnet, "bn_act_rule", lambda *a: False)


def test_forced_resnet18_takes_17_passes(forced, monkeypatch):
    """Through ``SoftNBDT(fused=True)``: the stem and every conv of the 8
    blocks, the shortcut's BatchNorm inside the last pass of stages 2-4; the
    leaves as on the library's passes."""
    from nbdt_torch import SoftNBDT
    from nbdt_torch.models import ResNet18

    net = SoftNBDT("CIFAR10", _seeded(ResNet18(10), 5), tree=grouped_tree(10, 3), fused=True,
                   device="cpu")
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(6))
    got = net(x).as_subclass(torch.Tensor)
    assert len(forced) == 17
    assert net._input(x).is_contiguous()
    _plain(monkeypatch)
    torch.testing.assert_close(got, net(x).as_subclass(torch.Tensor), rtol=1e-5, atol=1e-6)
    assert len(forced) == 17


@pytest.mark.parametrize("arch, passes", [("resnet50", 49), ("hrnet", 220)])
def test_forced_bottleneck_and_hrnet_passes(forced, monkeypatch, arch, passes):
    """resnet50: 3 passes a Bottleneck and the stem (16 * 3 + 1). HRNetV2
    with W48's structure (blocks 4, modules 1/4/3) at narrow widths: 12 in
    the four stage-1 Bottlenecks and 208 in the branches' BasicBlocks; its
    own stem, transitions, exchange units and head keep the library's."""
    from nbdt_torch.models import HRNetV2, resnet50

    if arch == "resnet50":
        model = _seeded(resnet50(10), 7)
        x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(8))
    else:
        model = _seeded(HRNetV2(150, widths=(4, 8, 16, 32), stem_width=8), 9)
        x = torch.randn(1, 3, 36, 36, generator=torch.Generator().manual_seed(10))
    with torch.no_grad():
        got = model(x)
        assert len(forced) == passes
        _plain(monkeypatch)
        want = model(x)
    # the seeded HRNet's logits reach thousands: rounding is relative to that
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


BYPASSES = ("train", "grad", "bf16", "folded", "channels_last", "export")


@pytest.mark.parametrize("case", BYPASSES)
def test_forced_rule_bypasses(forced, tmp_path, case):
    """Even with the rule on for the CPU, no pass goes to the kernel where
    the rule reads batch statistics, autograd, bf16, a folded model (no
    BatchNorm), channels-last, or an export trace."""
    from nbdt_torch.models import ResNet10, fold_batchnorm
    from nbdt_torch.serving import export_serving

    model = _seeded(ResNet10(10), 11)
    x = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(12))
    if case == "train":
        model.train()(x).sum().backward()
    elif case == "grad":
        model(x)
    elif case == "bf16":
        low = ResNet10(10, dtype=torch.bfloat16).eval()
        low.load_state_dict(model.state_dict())
        with torch.no_grad():
            low(x.bfloat16())
    elif case == "folded":
        with torch.no_grad():
            fold_batchnorm(model)(x)
    elif case == "channels_last":
        with torch.no_grad():
            model.to(memory_format=torch.channels_last)(
                x.contiguous(memory_format=torch.channels_last))
    else:
        export_serving(model, grouped_tree(10, 3), str(tmp_path / "r.pt2"), 16, bf16=False,
                       device="cpu")
    assert forced == []


# ---------------------------------------------------------------- on a card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_bn_act_kernel_matches_plain_on_gpu():
    """Bit for bit, each variant: ResNet18's first stage and its 4x4 stage
    at 8192 images, HRNetV2-W48's four branches at 32 images (130x130,
    65x65, 33x33, 17x17), planes of 1 and 3 elements and a tensor of odd
    size."""
    _card()
    from nbdt_torch.ops import bn_act as ba

    shapes = [(8192, 64, 32, 32), (8192, 512, 4, 4), (32, 48, 130, 130), (32, 96, 65, 65),
              (32, 192, 33, 33), (32, 384, 17, 17), (3, 5, 7, 7), (2, 3, 1, 1), (2, 3, 1, 3),
              (1, 3, 5, 7)]
    for i, shape in enumerate(shapes):
        for residual in VARIANTS:
            x, bn, r, rbn = _case(shape, residual, seed=i, device="cuda")
            with torch.no_grad():
                want = ba.bn_act_reference(x, bn, r, rbn)
                before = ba.launches
                got = ba.fused_bn_act(x, bn, r, rbn)
            torch.cuda.synchronize()
            assert ba.launches == before + 1 and got.data_ptr() == x.data_ptr()
            assert torch.equal(got, want), (shape, residual)
            del x, r, got, want


def _tf32_off():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return saved


def _restore(saved):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
def test_bn_act_launches_per_forward_on_gpu(monkeypatch):
    """f32, TF32 off: 17 launches a ``SoftNBDT(fused=True)`` request over
    ResNet18 and 220 a ``SoftSegNBDT`` request over HRNetV2-W48; the leaves
    and the seg logits of the library's passes, the logits within 1e-5 of
    their largest magnitude (the seeded, uncalibrated HRNet's grow to
    hundreds, and its per-pixel probabilities saturate); none in a
    ``make_train_step`` step or a ViT request."""
    _card()
    from nbdt_torch import SoftNBDT
    from nbdt_torch.model import SoftSegNBDT
    from nbdt_torch.models import ResNet18, hrnetv2_w48, resnet, vit_s16
    from nbdt_torch.ops import bn_act as ba
    from nbdt_torch.rules import to_device_tree
    from nbdt_torch.trainer import TrainConfig, lr_schedule, make_optimizer, make_train_step
    from test_torch_hrnet import ade20k_tree

    saved = _tf32_off()
    try:
        g = torch.Generator("cuda").manual_seed(1)
        tree = grouped_tree(10, 3)
        net = SoftNBDT("CIFAR10", _seeded(ResNet18(10), 2), tree=tree, fused=True)
        x = torch.randn(256, 32, 32, 3, device="cuda", generator=g)
        seg = SoftSegNBDT("ADE20K", _seeded(hrnetv2_w48(150), 3), tree=ade20k_tree())
        xs = torch.randn(2, 128, 128, 3, device="cuda", generator=g)
        counts = []
        for model, inputs in ((net, x), (seg, xs)):
            before = ba.launches
            model(inputs)
            counts.append(ba.launches - before)
        assert counts == [17, 220]

        def outputs():
            with torch.no_grad():
                return (net(x).as_subclass(torch.Tensor),
                        seg.model(seg._input(xs)))  # logits: the seeded net's reach hundreds

        got = outputs()
        monkeypatch.setattr(resnet, "bn_act_rule", lambda *a: False)
        before = ba.launches
        want = outputs()
        assert ba.launches == before
        monkeypatch.undo()
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
        assert float((got[1] - want[1]).abs().max()) <= 1e-5 * float(want[1].abs().max())

        model = ResNet18(10).cuda().train()
        cfg = TrainConfig(batch_size=64, epochs=1, lr=0.1)
        step = make_train_step(model, make_optimizer(cfg, model.parameters()),
                               lr_schedule(cfg, 1), "SoftTreeSupLoss",
                               to_device_tree(tree.arrays, "cuda"))
        labels = torch.randint(0, 10, (64,), device="cuda", generator=g)
        vit = SoftNBDT("CIFAR10", vit_s16(10, image_size=32), tree=tree, fused=True)
        before = ba.launches
        step(x[:64], labels, 1.0, 1.0, 0)
        vit(x[:8])
        torch.cuda.synchronize()
        assert ba.launches == before
    finally:
        _restore(saved)


@pytest.mark.gpu
def test_export_and_load_on_gpu_launch_nothing(tmp_path):
    """``export_serving`` of an f32 ResNet18 on the card traces the
    library's passes (no launch inside the trace), and ``load_serving``'s
    program runs them: its leaves equal the live f32 serving function's,
    which takes the kernel (17 launches), within its tolerances."""
    _card()
    from nbdt_torch.models import ResNet18
    from nbdt_torch.ops import bn_act as ba
    from nbdt_torch.serving import export_serving, load_serving, make_serving_fn

    saved = _tf32_off()
    try:
        model, tree = _seeded(ResNet18(10), 4), grouped_tree(10, 3)
        before = ba.launches
        path = export_serving(model, tree, str(tmp_path / "r18.pt2"), 32, bf16=False)
        served = load_serving(path)
        g = torch.Generator("cuda").manual_seed(5)
        x = torch.randn(64, 32, 32, 3, device="cuda", generator=g)
        got = served(x)
        torch.cuda.synchronize()
        assert ba.launches == before
        want = make_serving_fn(model, tree, bf16=False)(x)
        assert ba.launches == before + 17
    finally:
        _restore(saved)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
