"""The depthwise conv + eval BatchNorm + swish pass (``nbdt_torch/ops/
dw_bn_swish.py``, ``csrc/dw_bn_swish.cu``) and its dispatch in
``nbdt_torch/models/efficientnet.py``.

On the CPU: the shape tables below against what B0-b at 88px and B7b at
600px feed their depthwise convs; the plain version against ``ConvBlock``'s
library path (``F.pad`` where TF's "SAME" pads, the conv, ``nn.BatchNorm2d``,
``F.silu``) at every (side, k, stride, pad) kind of both, and at the plain
family's symmetric pads, within :func:`sum_order_bound`; the wrapper's
refusals; the dispatch rule as a pure function; a B0-b forward on the CPU
bit for bit the library path's; and, with the rule forced on the CPU (the
plain version in the kernel's place, NCHW placement), the passes one forward
takes: 16 for B0-b, 55 for B7b (on the meta device), none for training,
autograd, bf16, channels-last or an export trace. On a card: the kernel
against its plain version at every B7b and B0-b shape, and launches per
request (55 for B7b; ResNet18, HRNetV2 and ViT none)."""

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

# (channels, input side, k, stride, blocks) of each depthwise conv kind, in order
B7B_SHAPES = ((64, 300, 3, 1, 1), (32, 300, 3, 1, 3), (192, 300, 3, 2, 1), (288, 150, 3, 1, 6),
              (288, 150, 5, 2, 1), (480, 75, 5, 1, 6), (480, 75, 3, 2, 1), (960, 38, 3, 1, 9),
              (960, 38, 5, 1, 1), (1344, 38, 5, 1, 9), (1344, 38, 5, 2, 1),
              (2304, 19, 5, 1, 12), (2304, 19, 3, 1, 1), (3840, 19, 3, 1, 3))
B0B_88_SHAPES = ((32, 44, 3, 1, 1), (96, 44, 3, 2, 1), (144, 22, 3, 1, 1), (144, 22, 5, 2, 1),
                 (240, 11, 5, 1, 1), (240, 11, 3, 2, 1), (480, 6, 3, 1, 2), (480, 6, 5, 1, 1),
                 (672, 6, 5, 1, 2), (672, 6, 5, 2, 1), (1152, 3, 5, 1, 3), (1152, 3, 3, 1, 1))
# (side, k, stride, TF SAME): every kind of both tables, and the plain family's
# symmetric pads at their stride-2 kinds
KINDS = sorted({(side, k, s, True) for _, side, k, s, _ in B7B_SHAPES + B0B_88_SHAPES}
               | {(side, k, 2, False) for _, side, k, s, _ in B7B_SHAPES + B0B_88_SHAPES
                  if s == 2}, reverse=True)


def pads_of(side, k, stride, tf):
    from nbdt_torch.models.efficientnet import same_pads

    return same_pads(side, side, k, stride) if tf and stride > 1 else [k // 2] * 4


def _bn(C, seed, device="cpu"):
    """An eval ``BatchNorm2d`` (eps 1e-3, EfficientNet's) with seeded scales,
    shifts and statistics."""
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(C, eps=1e-3).eval()
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(C, generator=g))
        bn.bias.copy_(0.1 * torch.randn(C, generator=g))
        bn.running_mean.copy_(0.5 * torch.randn(C, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(C, generator=g))
    return bn.to(device)


def _block(C, k, stride, tf, seed, device="cpu"):
    """A depthwise ``ConvBlock`` with swish, seeded, in eval mode."""
    from nbdt_torch.models.efficientnet import ConvBlock

    block = ConvBlock(C, C, k, stride, groups=C, tf_pad=tf)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        block.conv.weight.copy_(torch.randn(block.conv.weight.shape, generator=g) / k)
    block.bn = _bn(C, seed + 1)
    return block.to(device).eval()


def _input(N, C, side, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (2 * torch.randn(N, C, side, side, generator=g) + 0.3).to(device)


def sum_order_bound(x, weight, bn, stride, pads, want):
    """The largest gap two f32 evaluations of ``silu(bn(conv(x)))`` may
    show where they sum an output's k^2 products in another order (and
    round the BatchNorm's and swish's few steps apart): each sum is within
    (k^2 + 4) u of the sum of the magnitudes of its terms, u = 2^-24, the
    BatchNorm scales that by |s| and adds the mean's and bias's size, swish's
    slope is under 1.1, and the two sides differ by at most both errors."""
    u, k2 = 2.0 ** -24, weight.shape[-1] ** 2
    with torch.no_grad():
        mags = F.conv2d(F.pad(x.abs(), list(pads)), weight.abs(), stride=stride,
                        groups=x.shape[1])
        s = (bn.weight / torch.sqrt(bn.running_var + bn.eps)).abs().view(1, -1, 1, 1)
        size = ((mags + bn.running_mean.abs().view(1, -1, 1, 1)) * s
                + bn.bias.abs().view(1, -1, 1, 1))
        return 2 * 1.1 * (k2 + 4) * u * size + 8 * u * want.abs()


def assert_within_sum_order(got, want, x, weight, bn, stride, pads, case):
    assert got.shape == want.shape and got.dtype == torch.float32, case
    gap = (got - want).abs()
    bound = sum_order_bound(x, weight, bn, stride, pads, want)
    worst = float((gap / bound).max())
    assert worst <= 1.0, f"{case}: gap {float(gap.max()):.3g}, {worst:.3g} of the bound"


def _depthwise_inputs(model, x):
    """(channels, input side, k, stride, blocks) of each run of depthwise
    ConvBlocks a forward of ``model`` on ``x`` takes, in order."""
    from nbdt_torch.models.efficientnet import ConvBlock

    seen, hooks = [], []

    def hook(block, inputs, out):
        if block.conv.groups > 1:
            kind = (block.conv.in_channels, inputs[0].shape[-1], block.kernel, block.stride)
            if seen and seen[-1][:4] == kind:
                seen[-1] = (*kind, seen[-1][4] + 1)
            else:
                seen.append((*kind, 1))

    for m in model.modules():
        if isinstance(m, ConvBlock):
            hooks.append(m.register_forward_hook(hook))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return tuple(seen)


def test_shape_tables_are_what_the_models_feed_their_depthwise_convs():
    from nbdt_torch.models import efficientnet_b0b, efficientnet_b7b

    torch.manual_seed(0)
    assert _depthwise_inputs(efficientnet_b0b(10).eval(), torch.randn(1, 3, 88, 88)) \
        == B0B_88_SHAPES
    with torch.device("meta"):
        b7b = efficientnet_b7b(1000).eval()
    assert _depthwise_inputs(b7b, torch.empty(1, 3, 600, 600, device="meta")) == B7B_SHAPES
    assert sum(n for *_, n in B7B_SHAPES) == 55 and sum(n for *_, n in B0B_88_SHAPES) == 16


@pytest.mark.parametrize("side, k, stride, tf", KINDS)
def test_plain_version_matches_the_convblock_library_path(side, k, stride, tf):
    """On CPU tensors: ``F.pad`` (TF's asymmetric SAME at even sides, or
    ``k // 2`` a side) and a grouped conv, the BatchNorm as bn_act takes it,
    ``F.silu``; the wrapper on a CPU tensor returns the plain version and
    launches nothing."""
    from nbdt_torch.ops import dw_bn_swish as dw

    C = 6
    block = _block(C, k, stride, tf, seed=side + k)
    x = _input(2, C, side, seed=side * stride)
    pads = pads_of(side, k, stride, tf)
    with torch.no_grad():
        want = block(x)  # the CPU keeps the library's passes
        got = dw.dw_bn_swish_reference(x, block.conv.weight, block.bn, stride, pads)
        assert_within_sum_order(got, want, x, block.conv.weight, block.bn, stride, pads,
                                (side, k, stride, tf))
        before = dw.launches
        assert torch.equal(dw.fused_dw_bn_swish(x, block.conv.weight, block.bn, stride, pads),
                           got)
    assert dw.launches == before
    assert tuple(got.shape[-2:]) == (-(-side // stride),) * 2  # SAME: ceil(side / stride)


def test_dw_bn_swish_refusals():
    from nbdt_torch.ops.dw_bn_swish import fused_dw_bn_swish

    block = _block(8, 3, 2, True, seed=0)
    w, bn, pads = block.conv.weight, block.bn, [0, 1, 0, 1]
    x = _input(2, 8, 10, seed=1)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous NCHW f32"):
            fused_dw_bn_swish(x.bfloat16(), w, bn, 2, pads)
        with pytest.raises(ValueError, match="contiguous NCHW f32"):
            fused_dw_bn_swish(x.contiguous(memory_format=torch.channels_last), w, bn, 2, pads)
        with pytest.raises(ValueError, match="depthwise f32 weight"):
            fused_dw_bn_swish(x, torch.randn(8, 8, 3, 3), bn, 2, pads)  # not depthwise
        with pytest.raises(ValueError, match="depthwise f32 weight"):
            fused_dw_bn_swish(x, torch.randn(8, 1, 7, 7), bn, 2, pads)
        with pytest.raises(ValueError, match="depthwise f32 weight"):
            fused_dw_bn_swish(x, w.bfloat16(), bn, 2, pads)
        with pytest.raises(ValueError, match="stride"):
            fused_dw_bn_swish(x, w, bn, 3, pads)
        with pytest.raises(ValueError, match="pads"):
            fused_dw_bn_swish(x, w, bn, 2, [0, 3, 0, 1])
        with pytest.raises(ValueError, match="f32 \\[8\\]"):
            fused_dw_bn_swish(x, w, _bn(4, 0), 2, pads)
        with pytest.raises(ValueError, match="running statistics"):
            fused_dw_bn_swish(x, w, nn.BatchNorm2d(8, track_running_stats=False).eval(), 2,
                              pads)
        with pytest.raises(ValueError, match="batch statistics"):
            fused_dw_bn_swish(x, w, _bn(8, 0).train(), 2, pads)
    with pytest.raises(RuntimeError, match="forward only"):
        fused_dw_bn_swish(x, w, bn, 2, pads)  # autograd on, a weight that wants gradients


CUDA_F32_EVAL = ("cuda", torch.float32, True, False, False, False)


@pytest.mark.parametrize("depthwise, activate, k, stride, inputs, want", [
    (True, True, 3, 1, CUDA_F32_EVAL, True),
    (True, True, 5, 1, CUDA_F32_EVAL, True),
    (True, True, 3, 2, CUDA_F32_EVAL, True),
    (True, True, 5, 2, CUDA_F32_EVAL, True),
    (False, True, 3, 1, CUDA_F32_EVAL, False),  # a full or pointwise conv
    (True, False, 3, 1, CUDA_F32_EVAL, False),  # no swish after it
    (True, True, 1, 1, CUDA_F32_EVAL, False),
    (True, True, 7, 1, CUDA_F32_EVAL, False),
    (True, True, 3, 3, CUDA_F32_EVAL, False),
    (True, True, 3, 1, ("cuda", torch.bfloat16, True, False, False, False), False),
    (True, True, 3, 1, ("cuda", torch.float32, False, False, False, False), False),
    (True, True, 3, 1, ("cuda", torch.float32, True, True, False, False), False),
    (True, True, 3, 1, ("cuda", torch.float32, True, False, True, False), False),
    (True, True, 3, 1, ("cuda", torch.float32, True, False, False, True), False),
    (True, True, 3, 1, ("cpu", torch.float32, True, False, False, False), False),
    (True, True, 3, 1, ("meta", torch.float32, True, False, False, False), False),
])
def test_dw_bn_swish_rule(depthwise, activate, k, stride, inputs, want):
    from nbdt_torch.models.efficientnet import dw_bn_swish_rule

    assert dw_bn_swish_rule(depthwise, activate, k, stride, *inputs) is want


def _seeded_b0b(seed=3):
    """B0-b at 1000 classes with seeded convs and BatchNorms, eval."""
    from nbdt_torch.models import efficientnet_b0b
    from test_torch_efficientnet_reference import seeded_state

    model = efficientnet_b0b(1000)
    model.load_state_dict(seeded_state(model, seed))
    return model.eval()


def test_cpu_b0b_is_the_library_path_bit_for_bit(monkeypatch):
    """On the CPU every depthwise block keeps ``F.pad``, the conv, the
    BatchNorm module and ``F.silu``: the output equals, bit for bit, the
    ConvBlock as it was before the pass, with no branch to take."""
    from nbdt_torch.models import efficientnet
    from nbdt_torch.ops import dw_bn_swish as dw

    model = _seeded_b0b()
    x = _input(2, 3, 88, seed=4)
    before = dw.launches
    with torch.no_grad():
        got = model(x)

        def library(block, h):
            if block.tf_pad:
                h = efficientnet._same_pad(h, block.kernel, block.stride)
            h = block.bn(efficientnet._conv(block.conv, h).float())
            return F.silu(h) if block.activate else h

        monkeypatch.setattr(efficientnet.ConvBlock, "forward", library)
        want = model(x)
    assert dw.launches == before
    assert torch.equal(got, want)


@pytest.fixture
def forced(monkeypatch):
    """The rule as on a card for CPU (and meta) tensors and NCHW placement,
    so that the plain version runs where the kernel would; yields the list
    that collects one entry per pass."""
    from nbdt_torch.models import efficientnet, layout
    from nbdt_torch.ops import dw_bn_swish as dw

    rule, kernel, calls = efficientnet.bn_act_rule, dw.fused_dw_bn_swish, []

    def as_on_a_card(device_type, *rest):
        return rule("cuda" if device_type in ("cpu", "meta") else device_type, *rest)

    def counted(x, *args):
        calls.append(tuple(x.shape))
        return (dw.dw_bn_swish_reference if x.is_meta else kernel)(x, *args)

    monkeypatch.setattr(efficientnet, "bn_act_rule", as_on_a_card)
    monkeypatch.setattr(dw, "fused_dw_bn_swish", counted)
    monkeypatch.setattr(layout, "conv_memory_format", lambda *a: NCHW)
    yield calls


def test_forced_b0b_takes_16_passes(forced, monkeypatch):
    """Through ``SoftNBDT(fused=True)`` on the Imagenet1000 tree: each of
    B0-b's 16 blocks' depthwise ConvBlock, at the inputs the shape table
    gives, and leaves as on the library's passes."""
    from nbdt_torch import SoftNBDT
    from nbdt_torch.models import efficientnet
    from test_torch_efficientnet_reference import imagenet_tree

    net = SoftNBDT("Imagenet1000", _seeded_b0b(5), tree=imagenet_tree(), fused=True,
                   device="cpu")
    x = torch.randn(2, 88, 88, 3, generator=torch.Generator().manual_seed(6))
    got = net(x).as_subclass(torch.Tensor)
    assert forced == [(2, C, side, side) for C, side, _, _, n in B0B_88_SHAPES
                      for _ in range(n)]
    monkeypatch.setattr(efficientnet, "bn_act_rule", lambda *a: False)
    torch.testing.assert_close(got, net(x).as_subclass(torch.Tensor), rtol=1e-5, atol=1e-6)
    assert len(forced) == 16


def test_forced_b7b_takes_55_passes_on_its_depthwise_blocks(forced):
    """B7b at 600px on the meta device: the 55 MBConv blocks' depthwise
    ConvBlocks and nothing else (the stem, the expansions, the projections,
    the head conv and squeeze-excite keep the library's passes)."""
    from nbdt_torch.models import efficientnet_b7b

    with torch.device("meta"):
        model = efficientnet_b7b(1000).eval()
    with torch.no_grad():
        model(torch.empty(1, 3, 600, 600, device="meta"))
    assert forced == [(1, C, side, side) for C, side, _, _, n in B7B_SHAPES for _ in range(n)]


@pytest.mark.parametrize("case", ("train", "grad", "bf16", "channels_last", "export"))
def test_forced_rule_bypasses(forced, case):
    """Even with the rule on for the CPU, no pass goes to the kernel where
    the rule reads batch statistics, autograd, bf16 convs, channels-last
    or an export trace."""
    from nbdt_torch.models import efficientnet_b0b

    model = _seeded_b0b(7)
    x = _input(2, 3, 64, seed=8)  # planes of 2 or more a side: channels-last is not NCHW
    if case == "train":
        model.train()(x).sum().backward()
    elif case == "grad":
        model(x)
    elif case == "bf16":
        low = efficientnet_b0b(1000, dtype=torch.bfloat16).eval()
        low.load_state_dict(model.state_dict())
        with torch.no_grad():
            low(x)
    elif case == "channels_last":
        with torch.no_grad():
            model.to(memory_format=torch.channels_last)(
                x.contiguous(memory_format=torch.channels_last))
    else:
        with torch.no_grad():
            torch.export.export(model, (x,))
    assert forced == []


# ---------------------------------------------------------------- on a card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _tf32_off():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return saved


def _restore(saved):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
def test_dw_bn_swish_kernel_matches_plain_on_gpu():
    """Every B7b shape (TF SAME pads, 2 images) and every B0-b 88px shape,
    with the plain family's symmetric pads at the stride-2 ones, within
    :func:`sum_order_bound` of the plain version (the kernel sums each
    output's k^2 products in another order than the conv); TF32 off."""
    _card()
    from nbdt_torch.ops import dw_bn_swish as dw

    saved = _tf32_off()
    try:
        cases = [(C, side, k, s, tf) for C, side, k, s, _ in B7B_SHAPES + B0B_88_SHAPES
                 for tf in ((True, False) if s == 2 else (True,))]
        for i, (C, side, k, s, tf) in enumerate(cases):
            block = _block(C, k, s, tf, seed=i, device="cuda")
            x = _input(2, C, side, seed=100 + i, device="cuda")
            pads = pads_of(side, k, s, tf)
            with torch.no_grad():
                want = dw.dw_bn_swish_reference(x, block.conv.weight, block.bn, s, pads)
                before = dw.launches
                got = dw.fused_dw_bn_swish(x, block.conv.weight, block.bn, s, pads)
            torch.cuda.synchronize()
            assert dw.launches == before + 1 and got.is_contiguous()
            assert_within_sum_order(got, want, x, block.conv.weight, block.bn, s, pads,
                                    (C, side, k, s, tf))
            del x, got, want
    finally:
        _restore(saved)


@pytest.mark.gpu
def test_dw_bn_swish_launches_per_request_on_gpu():
    """f32, TF32 off: 55 launches a ``SoftNBDT(fused=True)`` request of 2
    images over B7b at 600px; none in a ResNet18, an HRNetV2-W48
    (``SoftSegNBDT``) or a ViT request."""
    _card()
    from nbdt_torch import SoftNBDT
    from nbdt_torch.model import SoftSegNBDT
    from nbdt_torch.models import ResNet18, efficientnet_b7b, hrnetv2_w48, vit_s16
    from nbdt_torch.ops import dw_bn_swish as dw
    from test_torch_efficientnet_reference import imagenet_tree
    from test_torch_hrnet import ade20k_tree

    saved = _tf32_off()
    try:
        g = torch.Generator("cuda").manual_seed(1)
        tree = grouped_tree(10, 3)
        requests = [
            (SoftNBDT("Imagenet1000", efficientnet_b7b(1000), tree=imagenet_tree(), fused=True),
             torch.randn(2, 600, 600, 3, device="cuda", generator=g)),
            (SoftNBDT("CIFAR10", ResNet18(10), tree=tree, fused=True),
             torch.randn(64, 32, 32, 3, device="cuda", generator=g)),
            (SoftSegNBDT("ADE20K", hrnetv2_w48(150), tree=ade20k_tree()),
             torch.randn(2, 128, 128, 3, device="cuda", generator=g)),
            (SoftNBDT("CIFAR10", vit_s16(10, image_size=32), tree=tree, fused=True),
             torch.randn(8, 32, 32, 3, device="cuda", generator=g)),
        ]
        counts = []
        for model, x in requests:
            before = dw.launches
            model(x)
            torch.cuda.synchronize()
            counts.append(dw.launches - before)
        assert counts == [55, 0, 0, 0]
    finally:
        _restore(saved)
