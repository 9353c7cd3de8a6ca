"""Serving export in the port: export_serving / load_serving over
torch.export and aot_compile over torch.compile, held against the JAX
package's make_serving_fn on the same weights (the cases of
tests/test_serving.py but shard_serving), with the node decisions exact f32
whatever matmul precision the caller set."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_port import REPO, induced_tree_pair, resnet_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)

IMG = 32


@pytest.fixture(scope="module", params=["ResNet10", "ResNet18"])
def flagship(request):
    """(JAX module, variables, JAX tree, port module, port tree) on the
    CIFAR10 tree each package induces from the same classifier."""
    from nbdt_tpu.assets import get_dataset_wnids

    module, variables, port = resnet_pair(request.param, img=IMG)
    centers = np.asarray(variables["params"]["linear"]["kernel"]).T
    jtree, ttree = induced_tree_pair(centers, get_dataset_wnids("CIFAR10"))
    return module, variables, jtree, port, ttree


_JAX_FNS = {}


def jax_serving(module, variables, tree, **kw):
    """The JAX serving fn, jitted once per weights and flags."""
    import jax
    from nbdt_tpu.serving import make_serving_fn

    key = (id(variables), tuple(sorted(kw.items(), key=lambda item: item[0])))
    if key not in _JAX_FNS:
        fn = jax.jit(make_serving_fn(module, variables, tree, **kw))
        _JAX_FNS[key] = lambda x: np.asarray(fn(x))
    return _JAX_FNS[key]


class PrecisionSpy(torch.utils._python_dispatch.TorchDispatchMode):
    """(operand shapes, float32 matmul precision) of every matrix product
    dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            self.calls.append((shapes, torch.get_float32_matmul_precision()))
        return func(*args, **(kwargs or {}))


@pytest.fixture()
def medium_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    yield
    torch.set_float32_matmul_precision(prev)


def tree_products(spy, tree):
    """The precisions of the products that touch the tree's N*K slots."""
    S = tree.arrays.num_inodes * tree.arrays.max_children
    return [prec for shapes, prec in spy.calls if any(S in shape for shape in shapes)]


def test_export_roundtrip_symbolic_batch(flagship, tmp_path):
    """One artifact serves batches 1, 3 and 5 (traced at 2); its outputs
    equal the port's live function and match the JAX serving function."""
    from nbdt_torch.serving import export_serving, load_serving, make_serving_fn

    module, variables, jtree, port, ttree = flagship
    path = str(tmp_path / "nbdt.pt2")
    assert export_serving(port, ttree, path, IMG, bf16=False, device="cpu") == path
    served = load_serving(path, device="cpu")
    live = make_serving_fn(port, ttree, bf16=False, device="cpu")
    want_fn = jax_serving(module, variables, jtree, bf16=False)
    rng = np.random.RandomState(0)
    for batch in (1, 3, 5):
        x = rng.randn(batch, IMG, IMG, 3).astype(np.float32)
        got = served(x)
        assert got.shape == (batch, 10)
        torch.testing.assert_close(got, live(x), rtol=0, atol=0)
        want = want_fn(x)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))


def test_export_bf16_backbone_argmax_parity(flagship, tmp_path):
    """The bf16 artifact keeps f32 node decisions: it equals the port's
    live bf16 function, and its argmax matches the JAX f32 path."""
    from nbdt_torch.serving import export_serving, load_serving, make_serving_fn

    module, variables, jtree, port, ttree = flagship
    path = export_serving(port, ttree, str(tmp_path / "bf16.pt2"), IMG, bf16=True,
                          device="cpu")
    x = np.random.RandomState(1).randn(8, IMG, IMG, 3).astype(np.float32)
    got = load_serving(path, device="cpu")(x)
    torch.testing.assert_close(got, make_serving_fn(port, ttree, device="cpu")(x),
                               rtol=0, atol=0)
    want = jax_serving(module, variables, jtree, bf16=False)(x)
    np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))


def test_export_folded_bn_argmax_parity(flagship, tmp_path):
    """fold_bn=True exports the folded graph (conv + bias + ReLU): bf16 and
    f32 artifacts keep the argmax of the JAX unfolded f32 path, the f32 one
    its values too."""
    from nbdt_torch.serving import export_serving, load_serving

    module, variables, jtree, port, ttree = flagship
    x = np.random.RandomState(2).randn(8, IMG, IMG, 3).astype(np.float32)
    want = jax_serving(module, variables, jtree, bf16=False)(x)
    for bf16 in (True, False):
        path = export_serving(port, ttree, str(tmp_path / f"folded-{bf16}.pt2"), IMG,
                              bf16=bf16, fold_bn=True, device="cpu")
        got = load_serving(path, device="cpu")(x).numpy()
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
        if not bf16:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    src = open(path, "rb").read()
    assert b"batch_norm" not in src  # the graph holds no BatchNorm


def test_export_uint8_input_matches_float_path(flagship, tmp_path):
    """uint8_input bakes the normalization in: raw uint8 into the artifact
    equals the JAX float path fed the same host-normalized pixels, and the
    JAX uint8 serving function."""
    from nbdt_tpu.data.transforms import CIFAR_MEAN, CIFAR_STD, normalize

    from nbdt_torch.serving import export_serving, load_serving

    module, variables, jtree, port, ttree = flagship
    path = export_serving(port, ttree, str(tmp_path / "u8.pt2"), IMG, bf16=False,
                          uint8_input=True, normalize=(CIFAR_MEAN, CIFAR_STD), device="cpu")
    u8 = np.random.RandomState(3).randint(0, 256, (4, IMG, IMG, 3), dtype=np.uint8)
    got = load_serving(path, device="cpu")(u8).numpy()
    want = jax_serving(module, variables, jtree, bf16=False)(normalize(u8, CIFAR_MEAN, CIFAR_STD))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    want_u8 = jax_serving(module, variables, jtree, bf16=False, uint8_input=True)(u8)
    np.testing.assert_allclose(got, want_u8, rtol=1e-4, atol=1e-5)
    with pytest.raises(Exception):  # the artifact's input is uint8 NHWC
        load_serving(path, device="cpu")(u8.astype(np.float32))


class TinyBackbone(torch.nn.Module):
    """conv3x3 + ReLU + mean + linear: a backbone that inductor compiles in
    seconds on the CPU (a ResNet takes half a minute or more)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.linear = torch.nn.Linear(8, 10)

    def forward(self, x):
        return self.linear(torch.relu(self.conv(x)).mean((2, 3)))


@pytest.fixture(scope="module")
def tiny():
    """(TinyBackbone, the port's CIFAR10 tree)."""
    from test_torch_port import tree_pair

    torch.manual_seed(0)
    return TinyBackbone().eval(), tree_pair("CIFAR10")[1]


@pytest.fixture(scope="module")
def compiled(tiny):
    """(live serving fn, its aot_compile at batch 4, the port tree, the
    backbone): compiled once, by inductor, as on the card."""
    from nbdt_torch.serving import aot_compile, make_serving_fn

    backbone, tree = tiny
    fn = make_serving_fn(backbone, tree, bf16=False, device="cpu")
    return fn, aot_compile(fn, batch=4, image_size=IMG, device="cpu"), tree, backbone


def test_aot_compile_fixed_batch(compiled):
    """aot_compile pins the batch, compiles before the first request, and
    serves the live function's output; its leaves are the JAX rules' on the
    same backbone logits."""
    import jax.numpy as jnp
    from nbdt_tpu.rules import soft_forward as jsoft_forward
    from nbdt_tpu.rules import to_device_tree as jdevice_tree
    from test_torch_port import tree_pair

    fn, aot, _, backbone = compiled
    x = np.random.RandomState(4).randn(4, IMG, IMG, 3).astype(np.float32)
    out = aot(x)
    assert out.shape == (4, 10) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, fn(x), rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        logits = backbone(torch.as_tensor(x).permute(0, 3, 1, 2)).numpy()
    jtree, _ = tree_pair("CIFAR10")
    want = np.asarray(jsoft_forward(jnp.asarray(logits), jdevice_tree(jtree.arrays)))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    zeros = aot(np.zeros((4, IMG, IMG, 3), np.float32))
    assert zeros.shape == (4, 10) and bool(torch.isfinite(zeros).all())


def test_tree_products_stay_exact_under_a_callers_precision(flagship, compiled, tmp_path,
                                                             medium_precision):
    """Under a caller's "medium" f32 precision, load_serving's and
    aot_compile's two tree products run at "highest", their leaves equal
    the same call under "highest", and the caller's setting is restored."""
    from nbdt_torch.serving import export_serving, load_serving

    _, _, _, port, ttree = flagship
    path = export_serving(port, ttree, str(tmp_path / "f32.pt2"), IMG, bf16=False,
                          device="cpu")
    callers = {"load_serving": (load_serving(path, device="cpu"), ttree),
               "aot_compile": compiled[1:3]}
    x = np.random.RandomState(5).randn(4, IMG, IMG, 3).astype(np.float32)
    for name, (fn, tree) in callers.items():
        spy = PrecisionSpy()
        with spy:
            got = fn(x)
        assert tree_products(spy, tree) == ["highest", "highest"], (name, spy.calls)
        assert torch.get_float32_matmul_precision() == "medium"
        torch.set_float32_matmul_precision("highest")
        try:
            want = fn(x)
        finally:
            torch.set_float32_matmul_precision("medium")
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["CIFAR10", "CIFAR100", "TinyImagenet200", "Imagenet1000",
                                  "synthetic"])
def test_soft_rules_are_one_graph(name):
    """torch.compile takes the soft rules whole: exact_matmul traces as a
    plain matmul, so dynamo finds no graph break."""
    from test_torch_port import tree_pair

    from nbdt_torch.rules import soft_forward, to_device_tree

    _, tree = tree_pair(name)
    jt = to_device_tree(tree.arrays, "cpu")
    z = torch.randn(4, tree.arrays.num_classes)
    explained = torch._dynamo.explain(lambda z: soft_forward(z, jt))(z)
    assert (explained.graph_count, explained.graph_break_count) == (1, 0)


def test_serving_fn_is_one_graph():
    """The whole ResNet18 serving function, backbone and soft rules, is one
    graph for torch.compile (what aot_compile compiles), in f32 and as the
    flagship's bf16 + folded + uint8."""
    from nbdt_torch.models import ResNet18
    from nbdt_torch.serving import make_serving_fn
    from nbdt_torch.tree import Tree

    torch.manual_seed(0)
    port, tree = ResNet18(10).eval(), Tree("CIFAR10")
    for kw in ({"bf16": False}, {"bf16": True, "fold_bn": True, "uint8_input": True}):
        fn = make_serving_fn(port, tree, device="cpu", **kw)
        x = torch.zeros((2, IMG, IMG, 3),
                        dtype=torch.uint8 if kw.get("uint8_input") else torch.float32)
        explained = torch._dynamo.explain(fn)(x)
        assert (explained.graph_count, explained.graph_break_count) == (1, 0), kw


def test_exact_matmul_is_unchanged_in_eager(medium_precision):
    """Outside compilation exact_matmul still switches to "highest" in the
    forward and the backward and restores the caller's setting."""
    from nbdt_torch.rules import exact_matmul

    a = torch.randn(5, 7, requires_grad=True)
    b = torch.randn(7, 3, requires_grad=True)
    spy = PrecisionSpy()
    with spy:
        exact_matmul(a, b).sum().backward()
    assert [prec for _, prec in spy.calls] == ["highest"] * 3
    assert torch.get_float32_matmul_precision() == "medium"


def test_artifact_is_self_contained(tiny, tmp_path):
    """A process that imports torch and nothing of the repository runs the
    artifact through torch.export.load(...).module() under "highest" and
    gets load_serving's leaves; the file keeps the weights channels-last."""
    from nbdt_torch.serving import export_serving, load_serving

    backbone, tree = tiny
    path = export_serving(backbone, tree, str(tmp_path / "u8.pt2"), IMG, bf16=False,
                          uint8_input=True, device="cpu")
    u8 = torch.randint(0, 256, (7, IMG, IMG, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(6))
    torch.save(u8, tmp_path / "x.pt")
    code = (
        "import sys, torch\n"
        "torch.set_float32_matmul_precision('highest')\n"
        "program = torch.export.load('u8.pt2')\n"
        "with torch.no_grad():\n"
        "    out = program.module()(torch.load('x.pt'))\n"
        "torch.save(out, 'out.pt')\n"
        "assert not [m for m in sys.modules if m.startswith(('nbdt', 'jax', 'flax'))]\n"
        "w = [v for k, v in program.state_dict.items() if v.dim() == 4]\n"
        "print(len(w), all(v.is_contiguous(memory_format=torch.channels_last) for v in w))\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_convs, channels_last = out.stdout.split()
    assert int(n_convs) > 0 and channels_last == "True"
    want = load_serving(path, device="cpu")(u8)
    torch.testing.assert_close(torch.load(tmp_path / "out.pt"), want, rtol=0, atol=1e-6)


def test_export_entry_points_default_to_cuda(tiny, tmp_path):
    """With no device=, export_serving, load_serving and aot_compile ask for
    CUDA; without a card that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default does not raise")
    from nbdt_torch.serving import aot_compile, export_serving, load_serving, make_serving_fn

    port, ttree = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_serving(port, ttree, str(tmp_path / "x.pt2"), IMG, bf16=False)
    path = export_serving(port, ttree, str(tmp_path / "cpu.pt2"), IMG, bf16=False, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_serving(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        aot_compile(make_serving_fn(port, ttree, bf16=False, device="cpu"), 2, IMG)


@pytest.mark.gpu
def test_artifact_traced_on_cpu_serves_on_the_card(tmp_path):
    """load_serving moves a program traced on the CPU to the card, where it
    equals the live function on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nbdt_torch.models import ResNet10
    from nbdt_torch.serving import export_serving, load_serving, make_serving_fn
    from nbdt_torch.tree import Tree

    torch.manual_seed(0)
    model, tree = ResNet10(10).eval(), Tree("CIFAR10")
    path = export_serving(model, tree, str(tmp_path / "cpu.pt2"), IMG, bf16=False, device="cpu")
    x = torch.randn(3, IMG, IMG, 3, device="cuda")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 convs in both
    try:
        got = load_serving(path, device="cuda")(x)
        want = make_serving_fn(model, tree, bf16=False)(x)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert got.device.type == "cuda"
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
