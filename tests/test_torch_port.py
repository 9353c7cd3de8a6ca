"""The PyTorch port (nbdt_torch): shared fixtures for the port's parity
tests, import hygiene, the default device, and the kernel check on a card.

The parity tests hand the same numpy inputs to ``nbdt_tpu`` (the reference,
on the CPU) and to ``nbdt_torch`` with ``device="cpu"``.
"""

import ast
import os
import subprocess
import sys
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "nbdt_tpu")

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


def _graph_tree(Digraph, Tree, spec):
    nodes, edges, leaves = spec
    G = Digraph()
    for wnid, label in nodes:
        G.add_node(wnid, label=label)
    for u, v in edges:
        G.add_edge(u, v)
    return Tree.from_graph(G, leaves, classes=[f"class{i}" for i in range(len(leaves))])


def tree_pair(name):
    """(nbdt_tpu Tree, nbdt_torch Tree) for a vendored dataset's induced
    graph, or for "synthetic" / "dag"."""
    from nbdt_tpu.hierarchy.digraph import Digraph as JDigraph
    from nbdt_tpu.tree import Tree as JTree

    from nbdt_torch.hierarchy.digraph import Digraph as TDigraph
    from nbdt_torch.tree import Tree as TTree

    if name in ("synthetic", "dag"):
        spec = SYNTHETIC if name == "synthetic" else DAG
        return _graph_tree(JDigraph, JTree, spec), _graph_tree(TDigraph, TTree, spec)
    return JTree(name), TTree(name)


def random_variables(variables, seed=0):
    """Perturb a JAX ResNet's BatchNorm parameters and running statistics so
    that folding and normalization are not near-identities."""
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
            elif "kernel" not in p[name]:
                walk(p[name], s[name])

    out = copy(variables)
    walk(out["params"], out["batch_stats"])
    return out


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
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_port_sources_have_no_jax_imports():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_entry_points_default_to_cuda():
    """With no device=, the entry points ask for CUDA; without a card that
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default does not raise")
    from nbdt_torch import SoftNBDT, make_serving_fn
    from nbdt_torch.models import ResNet10
    from nbdt_torch.ops.soft_traversal import prepare_head_constants

    _, tree = tree_pair("synthetic")
    model = ResNet10(7)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SoftNBDT(None, model, tree=tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serving_fn(model, tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_head_constants(tree.arrays, np.zeros((512, 7), np.float32))


@pytest.mark.gpu
def test_soft_head_kernel_matches_plain_on_gpu():
    """Kernel vs its plain version on the card, small sizes, both dtypes."""
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
