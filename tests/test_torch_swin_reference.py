"""Swin (``nbdt_torch/models/swin.py``) against the benchmark's plain
reference (``benchmark/reference/swin.py``) on the CPU: a tiny model at
Swin-B's widths and heads (embed 128, depths 2/2/2/2) at 96px with window
3, whose grids 24, 12, 6 and 3 give shifted blocks with masks, a stage at
its window's size and every merge, on one seeded state dict, with both
LayerNorms of the cell's path; ``SoftNBDT`` over it on the vendored
Imagenet1000 tree; Swin-B/384's sizes, keys and FLOPs on the meta device;
a model built on the meta device and loaded with ``assign=True``; the
windowed attention's work count and the LayerNorms' shapes against what
the layers see, and the reader of B2's roofline on Swin's path; the spans
inside the blocks, which change no arithmetic; and, on the card,
Swin-B/384 at the cell's request size."""

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

from benchmark.reference import swin as reference  # noqa: E402
from benchmark.reference import work  # noqa: E402
from benchmark.reference.tree import DATA, SoftRules, hierarchy  # noqa: E402

CELL = "swin_b_w12_384_imagenet1000.offline"
CONFIG = json.loads((REPO / "benchmark/configs/swin_b_w12_384_imagenet1000.json").read_text())
TINY = {**CONFIG["model"], "image_size": 96, "window_size": 3, "depths": [2, 2, 2, 2]}
# f32 through 8 blocks: the same products on both sides; they round apart in
# LayerNorm's formula, the mean's order, and the mask's add, which the
# program makes to the bias and the reference to the scores (about 3e-6 on
# logits of 3 here)
RTOL = ATOL = 2e-5


def seeded_state(model, seed):
    """A state dict for ``model``'s keys, as the benchmark seeds one:
    matrices N(0, 1/fan_in), bias tables N(0, 0.02^2), LayerNorm scales
    U(0.5, 1.5), biases N(0, 0.02^2)."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, like in model.state_dict().items():
        if key.endswith("relative_position_bias_table"):
            state[key] = 0.02 * torch.randn(like.shape, generator=gen)
        elif like.dim() == 1 and key.endswith("weight"):
            state[key] = 0.5 + torch.rand(like.shape, generator=gen)
        elif like.dim() == 1:
            state[key] = 0.02 * torch.randn(like.shape, generator=gen)
        else:
            state[key] = torch.randn(like.shape, generator=gen) / math.sqrt(like[0].numel())
    return state


def tiny_port(ln_impl="f32", **kw):
    from nbdt_torch.models.swin import SwinTransformer

    return SwinTransformer(96, 4, 128, (2, 2, 2, 2), (4, 8, 16, 32), 3, 1000,
                           ln_impl=ln_impl, **kw)


def tiny_pair(seed=0, ln_impl="f32"):
    """(the program's Swin, the reference) at the tiny sizes, in eval mode
    on one seeded state dict."""
    ref = reference.Swin.from_sizes(TINY)
    ref.load_state_dict(seeded_state(ref, seed), strict=True)
    port = tiny_port(ln_impl).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    return port, ref.eval()


def images(n, size=96, seed=1):
    return torch.randn(n, 3, size, size, generator=torch.Generator().manual_seed(seed))


def imagenet_tree():
    from nbdt_torch.tree import Tree

    t = CONFIG["tree"]
    return Tree(t["dataset"], path_graph=str(DATA / t["graph"]),
                path_wnids=str(DATA / t["wnids"]))


@pytest.mark.parametrize("ln_impl", ["f32", "pallas"])
def test_tiny_swin_matches_the_reference(ln_impl):
    """"pallas" takes B2's plain twin on the CPU, at widths 128 to 4096."""
    port, ref = tiny_pair(ln_impl=ln_impl)
    x = images(2)
    with torch.no_grad():
        got, want = port(x), ref(x)
        got_f, want_f = port(x, features_only=True), ref.features(x)
    assert got.shape == want.shape == (2, 1000) and got_f.shape == want_f.shape == (2, 1024)
    assert got_f.is_contiguous() and got_f.dtype == torch.float32
    assert (want[0] - want[1]).abs().max() > 1.0, "the logits differ between images"
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got_f, want_f, rtol=RTOL, atol=ATOL)


def test_the_tiny_model_has_every_kind_of_block():
    """Shifted blocks with masks in the first three stages, none in the
    last (its grid is its window), a merge after each stage but the last;
    the geometry's order is the reference's roll and window cut, and its
    mask the official one."""
    from nbdt_torch.models.swin import window_geometry

    port, ref = tiny_pair()
    assert [[b.shift for b in layer.blocks] for layer in port.layers] == [[0, 1]] * 3 + [[0, 0]]
    assert [b.shift for b in ref.blocks()] == [0, 1] * 3 + [0, 0]
    assert [layer.downsample is not None for layer in port.layers] == [True] * 3 + [False]
    for side, shift in ((24, 1), (12, 1), (6, 1), (6, 0), (3, 0)):
        order, inverse, index, mask = window_geometry(side, 3, shift, "cpu")
        grid = torch.arange(side * side).view(1, side, side, 1)
        rolled = torch.roll(grid, (-shift, -shift), (1, 2)) if shift else grid
        assert torch.equal(order, reference.window_partition(rolled, 3).flatten())
        assert torch.equal(order[inverse], torch.arange(side * side))
        assert torch.equal(index, reference.relative_position_index(3, "cpu").flatten())
        if shift:
            assert torch.equal(mask, reference.shift_mask(side, 3, shift, "cpu"))
        else:
            assert mask is None


def test_soft_nbdt_matches_the_reference_through_the_soft_rules():
    from nbdt_torch.model import SoftNBDT

    port, ref = tiny_pair(seed=2, ln_impl="pallas")
    x = images(3, seed=3)
    rules = SoftRules(hierarchy(CONFIG), "cpu")
    with torch.no_grad():
        want = rules.probs(ref(x))
    for fused in (False, True):
        got = SoftNBDT("Imagenet1000", port, tree=imagenet_tree(), fused=fused,
                       device="cpu")(x.permute(0, 2, 3, 1))
        torch.testing.assert_close(got.as_subclass(torch.Tensor), want, rtol=1e-5, atol=1e-6)


def test_swin_b_sizes_keys_and_flops_on_the_meta_device():
    """87,903,584 parameters (the paper's 88 M), 24 blocks, 1024 features;
    the program's state-dict keys at the reference's shapes, floats only;
    the configuration's frozen FLOPs (the paper's 47.0 G multiply-adds)."""
    from nbdt_torch.models import get_model

    with torch.device("meta"):
        ref = reference.Swin.from_sizes(CONFIG["model"])
        port = get_model("swin_b_w12_384", 1000, ln_impl="pallas", image_size=384)
    assert sum(p.numel() for p in ref.parameters()) == 87_903_584
    assert sum(p.numel() for p in port.parameters()) == 87_903_584
    assert len(ref.blocks()) == sum(len(layer.blocks) for layer in port.layers) == 24
    assert ref.classifier.in_features == port.num_features == CONFIG["model"]["feature_dim"]
    assert ({k: v.shape for k, v in ref.state_dict().items()}
            == {k: v.shape for k, v in port.state_dict().items()})
    assert all(v.is_floating_point() for v in port.state_dict().values())
    assert not list(port.buffers())
    flops = work.flops_per_image(lambda: reference.Swin.from_sizes(CONFIG["model"]),
                                 hierarchy(CONFIG), CONFIG["model"]["image_size"])
    assert flops == CONFIG["flops_per_image"]["serve"]
    assert round(flops / 2e9, 1) == 47.1  # multiply-adds, the soft rules' 4 M included


def test_built_on_the_meta_device_and_loaded_by_assignment_it_runs():
    """As the benchmark builds the program: on the meta device, then
    ``load_state_dict(assign=True)``. No tensor is left on meta, and the
    geometry each stage builds at its first call lands on the input's
    device."""
    from nbdt_torch.models.swin import SwinTransformer

    port, ref = tiny_pair(seed=4)
    with torch.device("meta"):
        built = SwinTransformer(96, 4, 128, (2, 2, 2, 2), (4, 8, 16, 32), 3, 1000,
                                ln_impl="pallas")
    built.load_state_dict(ref.state_dict(), strict=True, assign=True)
    assert all(t.device.type == "cpu" for t in list(built.parameters()) + list(built.buffers()))
    x = images(2, seed=5)
    with torch.no_grad():
        torch.testing.assert_close(built.eval()(x), ref(x), rtol=RTOL, atol=ATOL)
    kept = [t for layer in built.layers for g in layer._geometry.values() for t in g
            if t is not None]
    assert kept and all(t.device.type == "cpu" for t in kept)


def test_window_attention_work_counts_what_the_layers_see():
    """Forward hooks on the reference's blocks count each windowed
    attention's products (qkv, scores, values, proj) from the shapes its
    layers see, its input and output elements and its parameters;
    ``window_attention_work`` gives the same from the sizes alone."""
    with torch.device("meta"):
        ref = reference.Swin.from_sizes(TINY).eval()
    seen = []

    def count(attn, inputs, out):
        (x,) = inputs[:1]
        Bw, N, C = x.shape
        flops = 2 * (x.numel() * 3 * C + 2 * Bw * N * N * C + x.numel() * C)
        params = sum(p.numel() for p in attn.parameters())
        seen.append({"flops": flops, "bytes": 4 * (x.numel() + out.numel() + params)})

    for block in ref.blocks():
        block.attn.register_forward_hook(count)
    with torch.no_grad():
        ref(torch.empty(3, 3, 96, 96, device="meta"))
    assert len(seen) == 8
    assert reference.window_attention_work(TINY, 3) == seen


def test_layernorm_shapes_are_the_ones_the_program_normalizes():
    """``layernorm_shapes`` lists, in order, the (rows, width) of every
    LayerNorm of the program's forward: with ``ln_impl="pallas"`` on the
    card, one B2 launch each, 53 for Swin-B."""
    from nbdt_torch.models.vit import LayerNorm

    port = tiny_port("pallas").eval()
    seen = []
    for m in port.modules():
        if isinstance(m, LayerNorm):
            m.register_forward_pre_hook(
                lambda mod, args: seen.append((args[0].numel() // args[0].shape[-1],
                                               args[0].shape[-1])))
    with torch.no_grad():
        port(images(3))
    assert len(seen) == 21  # 1 + 2 x 8 blocks + 3 merges + 1
    assert reference.layernorm_shapes(TINY, 3) == seen
    assert len(reference.layernorm_shapes(CONFIG["model"], 128)) == 53


def test_b2_swin_roofline_reads_a_request_of_layernorm_launches():
    """``b2_roofline.swin.serve``: the least time of a request's
    LayerNorms over the traced launches' mean times the launches a
    request; nothing where the run has no trace or no launch of B2."""
    from types import SimpleNamespace

    from benchmark import harness

    read = harness.load_module(REPO / "benchmark/metrics/b2_roofline.swin.serve.py").read
    cell = {"params": {"batch": 128}}
    least = sum(work.least_seconds(w["flops"], w["bytes"])
                for w in (work.layernorm_work(rows, dim)
                          for rows, dim in reference.layernorm_shapes(CONFIG["model"], 128)))
    launches = [(f"void (anonymous namespace)::layernorm_kernel<float, {v}>", t)
                for v, t in ((1, 4e-4), (4, 1e-4))] * 53
    gemm = [("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", 0.25)]
    run = SimpleNamespace(trace={"kernels": launches + gemm}, config=CONFIG, cell=cell)
    assert read(run) == pytest.approx(100 * least / (2.5e-4 * 53))
    assert 6.5e-3 < least < 6.7e-3  # 22.2 GB a request of 128 at the HBM rate
    for trace in (None, {"kernels": gemm}):
        assert read(SimpleNamespace(trace=trace, config=CONFIG, cell=cell)) is None


def test_swin_refuses_a_size_its_windows_do_not_fit():
    from nbdt_torch.models import get_model
    from nbdt_torch.models.swin import SwinTransformer

    with torch.device("meta"):
        with pytest.raises(ValueError, match="does not fit"):
            get_model("swin_b_w12_384", 1000, image_size=224)  # a grid of 56 in windows of 12
        with pytest.raises(ValueError, match="ln_impl"):
            get_model("swin_b_w12_384", 1000, ln_impl="fast")
        assert get_model("swin_b_w12_384", 10, image_size=32).layers[0].window == 8
    port = tiny_port()
    with pytest.raises(ValueError, match="96px"):
        port(images(1, size=64))
    with pytest.raises(ValueError):
        SwinTransformer(98, 4, 128, (2, 2), (4, 8), 3, 10)


def test_bf16_stream_keeps_f32_norms_and_head():
    """``dtype=bf16``: the patch conv and the linear layers but the head in
    bf16, the LayerNorms, bias tables and head in f32, f32 features within
    bf16's rounding of the f32 model's."""
    port, ref = tiny_pair(seed=6)
    half = tiny_port(dtype=torch.bfloat16).eval()
    half.load_state_dict(ref.state_dict(), strict=True)
    assert half.patch_embed.proj.weight.dtype == torch.bfloat16
    assert half.layers[2].blocks[1].attn.qkv.weight.dtype == torch.bfloat16
    assert half.layers[0].downsample.reduction.weight.dtype == torch.bfloat16
    assert half.layers[0].downsample.norm.weight.dtype == torch.float32
    assert half.layers[1].blocks[0].attn.relative_position_bias_table.dtype == torch.float32
    assert half.head.weight.dtype == torch.float32
    x = images(2, seed=7)
    with torch.no_grad():
        got, want = half(x, features_only=True), port(x, features_only=True)
    assert got.dtype == torch.float32
    assert float((got - want).norm() / want.norm()) < 0.05


def test_window_attention_and_mlp_spans_under_the_backbone():
    """Under a CPU profiler each request's ``backbone`` holds, block by
    block, ``window_attention`` and ``mlp``, each with the block's stage,
    shift and window count; without a profiler none records, and the
    answers are the same bit for bit."""
    from nbdt_torch import profiling
    from nbdt_torch.model import SoftNBDT

    port, _ = tiny_pair(ln_impl="pallas")
    nbdt = SoftNBDT("Imagenet1000", port, tree=imagenet_tree(), fused=True, device="cpu")
    x = images(2, seed=8).permute(0, 2, 3, 1)
    t0 = time.time_ns()
    plain = nbdt(x)
    assert not [s for s in profiling.spans(t0) if s["name"] in ("window_attention", "mlp")]
    t1 = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = [nbdt(x), nbdt(x)]
    assert all(torch.equal(t, plain) for t in traced)
    spans = profiling.spans(t1)
    requests = [s for s in spans if s["name"] == "request"]
    assert len(requests) == 2
    want = []
    for stage, windows in enumerate((2 * 64, 2 * 16, 2 * 4, 2 * 1)):
        for j in range(2):
            attrs = {"stage": stage, "shifted": stage < 3 and j == 1, "windows": windows}
            want += [("window_attention", attrs), ("mlp", attrs)]
    for request in requests:
        group = [s for s in spans if s["group"] == request["group"]]
        (backbone,) = [s for s in group if s["name"] == "backbone"]
        inner = [s for s in group if s["parent"] == backbone["id"]]
        assert [(s["name"], s["attrs"]) for s in inner] == want
        assert not [s for s in group if s["parent"] in {t["id"] for t in inner}]


@pytest.mark.gpu
def test_swin_b_request_on_the_card():
    """Swin-B/384 through ``SoftNBDT(fused=True)`` on the card at the cell's
    request of 128 images, with the cell's seeded weights, f32 and TF32
    off: placed in contiguous NCHW, B2 launched 53 times a request (the
    patch embedding, two a block, the three merges, the final norm), B1
    once, and the class probabilities within the cell's ``prob_gap`` of the
    plain reference's, computed in blocks of the cell's ``check_block``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import cells, harness
    from nbdt_torch.ops import layernorm, soft_traversal

    spec, cell, config = cells.cell_files(CELL)
    with harness.precision(False):
        ctx = harness.Context(CELL, cell, config, 2 ** 31 + 29, "cuda")
        nbdt = ctx.serve_system()
        assert nbdt._format == torch.contiguous_format
        x = ctx.images(cell["params"]["batch"], "pool0")
        nbdt(x)  # the first call loads the kernels
        ln0, head0 = layernorm.launches, soft_traversal.launches
        got = nbdt(x).float().cpu()
        assert (layernorm.launches - ln0, soft_traversal.launches - head0) == (53, 1)
        del nbdt
        harness.free_memory("cuda")
        ref = harness.ReferenceServe(ctx.reference(), ctx.rules(), tf32=False,
                                     block=cell["params"]["check_block"])
        want = ref(x).cpu()
    assert float((got - want).abs().max()) <= cell["limits"]["prob_gap"]
