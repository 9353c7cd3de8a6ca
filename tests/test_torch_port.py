"""The PyTorch port (nbdt_torch): shared fixtures for the port's parity
tests, import hygiene, the default device, and the kernel check on a card.

The parity tests hand the same numpy inputs to ``nbdt_tpu`` (the reference,
on the CPU) and to ``nbdt_torch`` with ``device="cpu"``.
"""

import ast
import contextlib
import os
import subprocess
import sys
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "orbax", "nbdt_tpu")

# The conftest ``synthetic_tree``: root -> (A, B, leaf6); A -> (leaf0, leaf1,
# leaf2); B -> (C, leaf5); C -> (leaf3, leaf4).
SYNTHETIC = (
    [(f"f{i:08d}", f"leaf{i}") for i in range(7)]
    + [("i0", "root"), ("i1", "A"), ("i2", "B"), ("i3", "C")],
    [("i0", "i1"), ("i0", "i2"), ("i0", "f00000006"), ("i1", "f00000000"),
     ("i1", "f00000001"), ("i1", "f00000002"), ("i2", "i3"),
     ("i2", "f00000005"), ("i3", "f00000003"), ("i3", "f00000004")],
    [f"f{i:08d}" for i in range(7)],
)
# A multi-path DAG: root -> {A, B}; A -> {l0, l1}; B -> {l1, l2}.
DAG = (
    [("f00000000", "root"), ("f00000001", "A"), ("f00000002", "B"),
     ("f00000003", "l0"), ("f00000004", "l1"), ("f00000005", "l2")],
    [("f00000000", "f00000001"), ("f00000000", "f00000002"),
     ("f00000001", "f00000003"), ("f00000001", "f00000004"),
     ("f00000002", "f00000004"), ("f00000002", "f00000005")],
    ["f00000003", "f00000004", "f00000005"],
)

# torch's intra-op threads for each port test module. The suite runs six
# xdist workers on the same cores; at torch's default of one thread a core,
# each worker's small ops mostly wait on the other workers' threads.
TEST_THREADS = 2


@contextlib.contextmanager
def intra_op_threads(n):
    """torch on ``n`` intra-op threads inside the block, and the count it
    had before afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Pin torch to ``TEST_THREADS`` intra-op threads for the whole module,
    module-scoped set-up included, and give the worker its own count back
    afterwards, so the JAX tests that share the worker are unaffected.
    Every ``tests/test_torch_*.py`` imports this fixture
    (``test_every_port_test_file_pins_its_threads``)."""
    with intra_op_threads(TEST_THREADS):
        yield


def _graph_tree(Digraph, Tree, spec):
    nodes, edges, leaves = spec
    G = Digraph()
    for wnid, label in nodes:
        G.add_node(wnid, label=label)
    for u, v in edges:
        G.add_edge(u, v)
    return Tree.from_graph(G, leaves, classes=[f"class{i}" for i in range(len(leaves))])


def grouped_tree(C, K, dag=False):
    """A port Tree of C leaves grouped K at a time up to one root (a lone
    node at the end of a level moves up as it is); with ``dag``, every 7th
    leaf also hangs under the parent of the leaf K places on."""
    from nbdt_torch.hierarchy.digraph import Digraph
    from nbdt_torch.tree import Tree

    G = Digraph()
    leaves = [f"f{i:08d}" for i in range(C)]
    for i, w in enumerate(leaves):
        G.add_node(w, label=f"leaf{i}")
    parent, level, n = {}, list(leaves), 0
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), K):
            group = level[i:i + K]
            if len(group) == 1:
                nxt.append(group[0])
                continue
            inner = f"n{n:07d}"
            n += 1
            G.add_node(inner, label=inner)
            for child in group:
                G.add_edge(inner, child)
                parent[child] = inner
            nxt.append(inner)
        level = nxt
    if dag:
        for i in range(0, C, 7):
            other = parent[leaves[(i + K) % C]]
            if other != parent[leaves[i]]:
                G.add_edge(other, leaves[i])
    return Tree.from_graph(G, leaves)


def tree_pair(name):
    """(nbdt_tpu Tree, nbdt_torch Tree) for a vendored dataset's induced
    graph, "<dataset>-<hierarchy>" for another vendored graph (e.g. the
    multi-path "CIFAR100-wordnet"), or "synthetic" / "dag"."""
    from nbdt_tpu.hierarchy.digraph import Digraph as JDigraph
    from nbdt_tpu.tree import Tree as JTree

    from nbdt_torch.hierarchy.digraph import Digraph as TDigraph
    from nbdt_torch.tree import Tree as TTree

    if name in ("synthetic", "dag"):
        spec = SYNTHETIC if name == "synthetic" else DAG
        return _graph_tree(JDigraph, JTree, spec), _graph_tree(TDigraph, TTree, spec)
    dataset, _, hierarchy = name.partition("-")
    kw = {"hierarchy": hierarchy} if hierarchy else {}
    return JTree(dataset, **kw), TTree(dataset, **kw)


def random_variables(variables, seed=0):
    """Perturb a JAX backbone's BatchNorm parameters and running statistics
    so that folding and normalization are not near-identities."""
    rng = np.random.RandomState(seed)

    def copy(tree):
        return {k: copy(v) if isinstance(v, Mapping) else np.array(v, np.float32)
                for k, v in tree.items()}

    def walk(p, s):
        for name in p:
            if "scale" in p[name]:
                c = p[name]["scale"].shape
                p[name]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                p[name]["bias"] = (0.1 * rng.randn(*c)).astype(np.float32)
                s[name]["mean"] = (0.1 * rng.randn(*c)).astype(np.float32)
                s[name]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif "kernel" not in p[name]:  # a block (a squeeze-excite has no statistics)
                walk(p[name], s.get(name, {}))

    out = copy(variables)
    walk(out["params"], out.get("batch_stats", {}))  # AlexNet, SqueezeNet: no BatchNorm
    return out


def zoo_pair(arch, img, num_classes=10, seed=0, **kw):
    """(flax module, numpy variables with perturbed BatchNorms, port module
    loaded from them in eval mode, seeded images [2, img, img, 3], the
    jitted JAX forward ``fwd(variables, x, features_only)``) for a zoo arch;
    ``kw`` go to both constructors (``classic_head``, ``transform_input``)."""
    import jax
    import jax.numpy as jnp
    from nbdt_tpu.models import get_model

    import nbdt_torch.models as tm

    module = get_model(arch, num_classes, **kw)
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)))
    variables = random_variables(variables, seed)
    port = tm.get_model(arch, num_classes, **kw)
    port.load_state_dict(tm.state_dict_from_flax(variables, arch), strict=True)
    x = np.random.RandomState(seed + 1).randn(2, img, img, 3).astype(np.float32)
    fwd = jax.jit(lambda v, x, f: module.apply(v, x, features_only=f), static_argnums=2)
    return module, variables, port.eval(), x, fwd


def induced_tree_pair(centers, wnids):
    """(nbdt_tpu Tree, nbdt_torch Tree) of the hierarchy each package
    induces from the same class centers ``[C, D]`` over ``wnids``."""
    from nbdt_tpu.hierarchy.build import build_induced_graph as jbuild
    from nbdt_tpu.tree import Tree as JTree

    from nbdt_torch.hierarchy.build import build_induced_graph as tbuild
    from nbdt_torch.tree import Tree as TTree

    classes = [f"c{i}" for i in range(len(wnids))]
    return (JTree.from_graph(jbuild(wnids, centers), wnids, classes=classes),
            TTree.from_graph(tbuild(wnids, centers), wnids, classes=classes))


def resnet_pair(arch="ResNet10", num_classes=10, img=32, seed=0):
    """(flax module, numpy variables, port module loaded from them)."""
    from nbdt_tpu.models import init_model

    import nbdt_torch.models as tm

    module, variables = init_model(arch, num_classes, (img, img, 3), seed=seed)
    variables = random_variables(variables, seed)
    port = getattr(tm, arch)(num_classes)
    port.load_state_dict(tm.state_dict_from_flax(variables, arch), strict=True)
    return module, variables, port.eval()


def _port_sources():
    return sorted((REPO / "nbdt_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_nothing_of_jax():
    """Importing nbdt_torch and loading chip_smoke.py (without running it)
    leaves no jax, flax or nbdt_tpu module loaded."""
    code = (
        "import importlib.util, sys\n"
        "import nbdt_torch, nbdt_torch.ops, nbdt_torch.models, nbdt_torch.serving\n"
        "import nbdt_torch.models.vit, nbdt_torch.ops.layernorm, nbdt_torch.ops.conv3x3\n"
        "import nbdt_torch.tools.probe_pallas_conv\n"
        "import nbdt_torch.losses, nbdt_torch.metrics, nbdt_torch.trainer, nbdt_torch.main\n"
        "import nbdt_torch.data, nbdt_torch.data.cifar, nbdt_torch.data.loader\n"
        "import nbdt_torch.hierarchy.build, nbdt_torch.hierarchy.cluster\n"
        "import nbdt_torch.hierarchy.generate\n"
        "import nbdt_torch.models.wideresnet, nbdt_torch.data.imagenet, nbdt_torch.analysis\n"
        "import nbdt_torch.models.efficientnet, nbdt_torch.models.resnet\n"
        "import nbdt_torch.serialization, nbdt_torch.models.utils, nbdt_torch.models.convert\n"
        "import nbdt_torch.bin.nbdt, nbdt_torch.bin.original, nbdt_torch.bin.nbdt_export\n"
        "import nbdt_torch.parallel, nbdt_torch.profiling\n"
        "import nbdt_torch.native, nbdt_torch.data.segmentation, nbdt_torch.models.segnet\n"
        "import nbdt_torch.models.hrnet\n"
        "import nbdt_torch.examples.train_seg\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'PIL' not in sys.modules, 'PIL imported at module level'\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def _worker_sources():
    """chip_smoke.py's worker programs (string constants it runs in
    subprocesses), as (name, source)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    return [(f"chip_smoke.{t.id}", node.value.value) for node in tree.body
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str) for t in node.targets
            if t.id.endswith("_WORKER")]


def test_port_sources_have_no_jax_imports():
    sources = [(p, p.read_text()) for p in _port_sources()] + _worker_sources()
    assert any(name == "chip_smoke.PAR_WORKER" for name, _ in sources)
    for path, text in sources:
        for node in ast.walk(ast.parse(text, str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_every_port_test_file_pins_its_threads():
    """Each ``tests/test_torch_*.py`` imports the autouse ``torch_threads``
    at module level (or, here, defines it), and this module runs under it."""
    assert torch.get_num_threads() == TEST_THREADS
    files = sorted((REPO / "tests").glob("test_torch_*.py"))
    assert len(files) > 30
    lacking = []
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        pinned = any(
            isinstance(node, ast.ImportFrom) and node.module == "test_torch_port"
            and any(a.name == "torch_threads" and a.asname is None for a in node.names)
            or isinstance(node, ast.FunctionDef) and node.name == "torch_threads"
            for node in tree.body)
        if not pinned:
            lacking.append(path.name)
    assert not lacking, f"import torch_threads from test_torch_port in: {lacking}"


def test_entry_points_default_to_cuda():
    """With no device=, the entry points ask for CUDA; without a card that
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default does not raise")
    from nbdt_torch import SoftNBDT, make_serving_fn
    from nbdt_torch.models import ResNet10, ViT
    from nbdt_torch.ops.soft_traversal import prepare_head_constants
    from nbdt_torch.tools.probe_pallas_conv import run_probe

    _, tree = tree_pair("synthetic")
    vit = ViT(dim=128, depth=1, heads=2, num_classes=7, ln_impl="pallas", image_size=32)
    for model in (ResNet10(7), vit):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SoftNBDT(None, model, tree=tree)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SoftNBDT(None, model, tree=tree, fused=True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_serving_fn(model, tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_head_constants(tree.arrays, np.zeros((512, 7), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_probe(4, 2, 1)

    # the training slice: the losses' tree constants, the trainer and the CLI
    from nbdt_torch.data import DataLoader, SyntheticDataset
    from nbdt_torch.losses import (CrossEntropyLoss, HardTreeSupLoss, SoftTreeLoss,
                                   SoftTreeSupLoss)
    from nbdt_torch.main import main
    from nbdt_torch.trainer import TrainConfig, Trainer

    for cls in (SoftTreeSupLoss, HardTreeSupLoss, SoftTreeLoss, CrossEntropyLoss):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(tree=tree)
    ds = SyntheticDataset(7, size=8, image_size=8)
    loader = DataLoader(ds, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig(batch_size=4), ResNet10(7), loader, loader, tree=tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--synthetic", "--arch", "ResNet10", "--epochs", "1", "--batch-size", "4"])

    # the WRN slice: the analyzers' rules and the CLI's --analysis eval
    from nbdt_torch import analysis

    for cls in (analysis.DecisionRules, analysis.SoftEmbeddedDecisionRules,
                analysis.HardEmbeddedDecisionRules, analysis.NBDTEntropyMaxMin):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(tree=tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        analysis.VisualizeDecisionNode(tree=tree, visualize_decision_node_wnid=tree.wnids_leaves[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--synthetic", "--dataset", "CIFAR100", "--arch", "ResNet10", "--eval",
              "--batch-size", "4", "--hierarchy", "induced-wrn28_10_cifar100",
              "--analysis", "SoftEmbeddedDecisionRules"])


@pytest.mark.gpu
def test_soft_head_kernel_matches_plain_on_gpu():
    """Kernel vs its plain version on the card, both dtypes: small sizes,
    then both instances of the kernel across batch sizes and trees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nbdt_torch.hierarchy.digraph import Digraph
    from nbdt_torch.ops import soft_traversal as st
    from nbdt_torch.tree import Tree

    ta = _graph_tree(Digraph, Tree, SYNTHETIC).arrays
    rng = np.random.RandomState(0)
    W = rng.randn(64, ta.num_classes).astype(np.float32) / 8
    feats = torch.as_tensor(np.abs(rng.randn(37, 64)).astype(np.float32), device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        hc = st.prepare_head_constants(ta, W, rng.randn(ta.num_classes), dtype=dtype)
        before = st.launches
        got = st.fused_soft_head(feats.to(dtype), hc, block_b=8)
        assert st.launches == before + 1
        want = st.soft_head_reference(feats.to(dtype), hc)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)

    # Both kernel instances: ragged batches, C either side of the plan's
    # switch at 32 classes, K=3, DAGs and a 1000-class tree, aux on and off.
    trees = {"synthetic K=3": (ta, 64), "DAG C=3": (_graph_tree(Digraph, Tree, DAG).arrays, 64),
             "C=32": (grouped_tree(32, 2).arrays, 64), "C=33 K=3": (grouped_tree(33, 3).arrays, 64),
             "DAG C=40": (grouped_tree(40, 2, dag=True).arrays, 64),
             "Imagenet1000": (Tree("Imagenet1000").arrays, 768),
             # the wide heads the cluster instance once refused (D no longer
             # takes shared memory): ResNet50's 2048, EfficientNet-B7's 2560
             "CIFAR100 D=2048": (Tree("CIFAR100").arrays, 2048),
             "Imagenet1000 D=2048": (Tree("Imagenet1000").arrays, 2048),
             "TinyImagenet200 D=2560": (Tree("TinyImagenet200").arrays, 2560),
             # WRN-28-10's heads: CIFAR100 and TinyImagenet200 at D=640
             "CIFAR100 D=640": (Tree("CIFAR100", hierarchy="induced-wrn28_10_cifar100").arrays,
                                640),
             "TinyImagenet200 D=640": (Tree("TinyImagenet200", hierarchy="induced-wrn28_10")
                                       .arrays, 640)}
    instances = set()
    for name, (arrays, D) in trees.items():
        W = rng.randn(D, arrays.num_classes).astype(np.float32) / np.sqrt(D)
        for B in (1, 17, 259):
            x = torch.as_tensor(np.abs(rng.randn(B, D)).astype(np.float32), device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                hc = st.prepare_head_constants(arrays, W, rng.randn(arrays.num_classes),
                                               dtype=dtype)
                for want_aux in (True, False):
                    got = st.fused_soft_head(x.to(dtype), hc, want_aux=want_aux)
                    want = st.soft_head_reference(x.to(dtype), hc, want_aux=want_aux)
                    torch.cuda.synchronize()
                    plan = st.last_launch["plan"]
                    instances.add(plan.instance)
                    print(f"{name} B={B} {dtype} aux={want_aux}: {plan.instance} q={plan.q}")
                    for g, w in zip(got, want):
                        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    assert instances == {"stream", "cluster"}


@pytest.mark.gpu
def test_layernorm_kernel_matches_plain_on_gpu():
    """Kernel vs its plain version on the card: register-held rows (D=128,
    384, 768) and a streamed one (D=2048 f32, D=4096 bf16), odd row counts,
    3-d input, both dtypes; f32 within 2e-5, bf16 within the bf16 defaults."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nbdt_torch.ops import layernorm as ln

    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in ((1, 128), (257, 384), (3, 67, 768), (33, 2048), (5, 4096)):
        D = shape[-1]
        w = torch.randn(D, device="cuda", generator=g)
        b = torch.randn(D, device="cuda", generator=g)
        x = torch.randn(shape, device="cuda", generator=g) * 3 + 1
        for dtype in (torch.float32, torch.bfloat16):
            before = ln.launches
            got = ln.fused_layernorm(x.to(dtype), w, b)
            assert ln.launches == before + 1
            want = ln.layernorm_reference(x.to(dtype), w, b)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == shape
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
            else:
                torch.testing.assert_close(got, want)
    empty = ln.fused_layernorm(torch.zeros(0, 128, device="cuda"), w[:128], b[:128])
    assert empty.shape == (0, 128)


@pytest.mark.gpu
def test_conv3x3_kernel_matches_plain_on_gpu():
    """Kernel vs its plain version on the card: N in {1, 3} on the probe's
    32x32 map, an odd 7x5 map (edges, a partial tile), 6x33 (a second,
    ragged column tile), 9x64 (two column tiles, a ragged band) and 33x70
    (three column tiles, the last ragged, and a ragged band); bf16
    assert_close defaults; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nbdt_torch.ops import conv3x3

    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(3, 3, 64, 64, device="cuda", generator=g) * 0.05
    b = torch.randn(64, device="cuda", generator=g) * 0.01
    for n in (1, 3):
        for h, wd in ((32, 32), (7, 5), (6, 33), (9, 64), (33, 70)):
            x = torch.randn(n, h, wd, 64, device="cuda", generator=g).bfloat16()
            before = conv3x3.launches
            got = conv3x3.conv3x3_bias_relu(x, w, b)
            assert conv3x3.launches == before + 1
            want = conv3x3.conv3x3_bias_relu_reference(x, w, b)
            torch.cuda.synchronize()
            assert got.dtype == torch.bfloat16 and got.shape == (n, h, wd, 64)
            torch.testing.assert_close(got, want)
    assert conv3x3.conv3x3_bias_relu(x[:0], w, b).shape == (0, *x.shape[1:])
