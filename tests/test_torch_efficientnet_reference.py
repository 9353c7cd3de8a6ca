"""EfficientNet (``nbdt_torch/models/efficientnet.py``) against the
benchmark's plain reference (``benchmark/reference/efficientnet.py``) on the
CPU: a tiny ``efficientnet_b0b`` on one seeded state dict with perturbed
BatchNorms at 64px (every stride-2 conv padded asymmetrically, as TF's
"SAME" pads an even side) and 65px (every one symmetrically), contiguous
and channels-last; B7b's sizes, keys and work on the meta device; the
depthwise work count against the shapes the layers see; ``SoftNBDT`` over
the tiny model on the vendored Imagenet1000 tree; and the spans inside the
MBConv blocks, which change no arithmetic."""

import json
import math
import sys
import time
from pathlib import Path

import pytest
import torch

from test_torch_port import torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.reference import efficientnet as reference  # noqa: E402
from benchmark.reference import work  # noqa: E402
from benchmark.reference.tree import DATA, SoftRules, hierarchy  # noqa: E402

CONFIG = json.loads((REPO / "benchmark/configs/efficientnet_b7b_imagenet1000.json").read_text())
B0 = {**CONFIG["model"], "width_mult": 1.0, "depth_mult": 1.0, "feature_dim": 1280}
# f32 through 16 blocks in one layout: the same convs on both sides, rounding
# apart only where the program pads in the conv and the reference in F.pad
RTOL = ATOL = 1e-5


def seeded_state(model, seed):
    """A state dict for ``model``'s keys: convs and the classifier N(0,
    1/fan_in); BatchNorm scales and variances U(0.5, 1.5), means and biases
    N(0, 0.1^2)."""
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


def tiny_pair(seed=0):
    """(the program's ``efficientnet_b0b``, the reference at B0's sizes),
    both in eval mode on one seeded state dict whose BatchNorm statistics
    are then set from 16 seeded images (random statistics over 16 blocks
    map every image to the same logits)."""
    from nbdt_torch.models import efficientnet_b0b

    ref = reference.EfficientNet.from_sizes(B0)
    ref.load_state_dict(seeded_state(ref, seed), strict=True)
    norms = [m for m in ref.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.momentum = 1.0
    with torch.no_grad():
        ref.train()(images(16, 64, seed=seed + 100))
    for m in norms:
        m.momentum = 0.1
    port = efficientnet_b0b(1000).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    return port, ref.eval()


def images(n, size, seed=1):
    return torch.randn(n, 3, size, size, generator=torch.Generator().manual_seed(seed))


def imagenet_tree():
    from nbdt_torch.tree import Tree

    t = CONFIG["tree"]
    return Tree(t["dataset"], path_graph=str(DATA / t["graph"]),
                path_wnids=str(DATA / t["wnids"]))


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("size", [64, 65])
def test_tiny_b0b_matches_the_reference(size, layout):
    """Channels-last is the layout the wrappers give on the CPU. The
    reference runs in the program's layout: its own channels-last convs
    round apart from its NCHW ones by up to 2.7e-4 on logits of 66 here."""
    port, ref = tiny_pair()
    x = images(2, size)
    if layout == "channels_last":
        port = port.to(memory_format=torch.channels_last)
        ref = ref.to(memory_format=torch.channels_last)
        x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got, want = port(x), ref(x)
        got_f, want_f = port(x, features_only=True), ref.features(x)
    assert got.shape == want.shape == (2, 1000) and got_f.shape == want_f.shape == (2, 1280)
    assert (want[0] - want[1]).abs().max() > 1.0, "the logits differ between images"
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got_f, want_f, rtol=RTOL, atol=ATOL)


def test_b7b_sizes_keys_and_work_on_the_meta_device():
    """66,347,960 parameters, 55 blocks and 2560 features; the program's
    state-dict keys at the same shapes; the configuration's frozen FLOPs."""
    from nbdt_torch.models import efficientnet_b7b
    from nbdt_torch.models.efficientnet import MBConv

    with torch.device("meta"):
        ref = reference.EfficientNet.from_sizes(CONFIG["model"])
        port = efficientnet_b7b(1000)
    assert sum(p.numel() for p in ref.parameters()) == 66_347_960
    assert len(ref.features.blocks()) == sum(isinstance(m, MBConv) for m in port.modules()) == 55
    assert ref.classifier.in_features == port.num_features == CONFIG["model"]["feature_dim"]
    assert ({k: v.shape for k, v in ref.state_dict().items()}
            == {k: v.shape for k, v in port.state_dict().items()})
    flops = work.flops_per_image(lambda: reference.EfficientNet.from_sizes(CONFIG["model"]),
                                 hierarchy(CONFIG), CONFIG["model"]["image_size"])
    assert flops == CONFIG["flops_per_image"]["serve"]


@pytest.mark.parametrize("size", [64, 65, 88])
def test_depthwise_work_counts_what_the_layers_see(size):
    """Forward hooks on the reference's depthwise layers (each grouped conv
    with its pad) count their input, output and weight elements and their
    operations; ``depthwise_work`` gives the same from the sizes alone."""
    sizes = {**B0, "image_size": size}
    with torch.device("meta"):
        ref = reference.EfficientNet.from_sizes(sizes).eval()
    seen = {"flops": 0, "bytes": 0, "layers": 0}

    def count(layer, inputs, out):
        conv = layer.conv
        assert conv.groups == conv.in_channels == conv.out_channels
        seen["flops"] += 2 * conv.kernel_size[0] * conv.kernel_size[1] * out.numel()
        seen["bytes"] += 4 * (inputs[0].numel() + out.numel() + conv.weight.numel())
        seen["layers"] += 1

    for block in ref.features.blocks():
        block.depthwise.register_forward_hook(count)
    with torch.no_grad():
        ref(torch.empty(3, 3, size, size, device="meta"))
    assert seen["layers"] == 16
    assert reference.depthwise_work(sizes, 3) == {"flops": seen["flops"],
                                                  "bytes": seen["bytes"]}


def test_soft_nbdt_matches_the_reference_through_the_soft_rules():
    from nbdt_torch.model import SoftNBDT

    port, ref = tiny_pair(seed=2)
    x = images(3, 64, seed=3)
    rules = SoftRules(hierarchy(CONFIG), "cpu")
    with torch.no_grad():
        want = rules.probs(ref(x))
    for fused in (False, True):
        got = SoftNBDT("Imagenet1000", port, tree=imagenet_tree(), fused=fused,
                       device="cpu")(x.permute(0, 2, 3, 1))
        torch.testing.assert_close(got.as_subclass(torch.Tensor), want, rtol=1e-5, atol=1e-6)


def test_mbconv_spans_under_the_backbone():
    """Under a CPU profiler each request's ``backbone`` holds, block by
    block, ``pointwise`` (where the block expands), ``depthwise``, ``se`` and
    ``pointwise``: 16, 16 and 31 at B0; without a profiler none records, and
    the answers are the same bit for bit."""
    from nbdt_torch import profiling
    from nbdt_torch.model import SoftNBDT
    from nbdt_torch.models.efficientnet import MBConv

    port, _ = tiny_pair()
    nbdt = SoftNBDT("Imagenet1000", port, tree=imagenet_tree(), fused=True, device="cpu")
    x = images(2, 65).permute(0, 2, 3, 1)
    t0 = time.time_ns()
    plain = nbdt(x)
    assert not [s for s in profiling.spans(t0) if s["name"] in ("pointwise", "depthwise", "se")]
    t1 = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = [nbdt(x), nbdt(x)]
    assert all(torch.equal(t, plain) for t in traced)
    spans = profiling.spans(t1)
    requests = [s for s in spans if s["name"] == "request"]
    assert len(requests) == 2
    want = []
    for block in port.features.modules():
        if isinstance(block, MBConv):
            want += ["pointwise"] * block.expand + ["depthwise", "se", "pointwise"]
    for request in requests:
        group = [s for s in spans if s["group"] == request["group"]]
        (backbone,) = [s for s in group if s["name"] == "backbone"]
        inner = [s for s in group if s["parent"] == backbone["id"]]
        assert [s["name"] for s in inner] == want
        assert (want.count("depthwise"), want.count("se"), want.count("pointwise")) == (16, 16, 31)
        assert all(s["attrs"] == {} for s in inner)
        assert not [s for s in group if s["parent"] in {t["id"] for t in inner}]
