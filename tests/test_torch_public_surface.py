"""The last public surface of ``nbdt_tpu`` on the port: the package's and the
hierarchy package's re-exports, ``Tree.create_from_args``, the Node helpers,
``Digraph.remove_node``, ``apply_augment_numpy``, the embedded wnid tables
behind ``get_dataset_wnids`` and the two hierarchy console scripts, each
held against the JAX package on the CPU.

The hierarchy package re-exports a function named ``test_hierarchy``: it is
reached here as an attribute only, never imported into this module, so that
pytest does not collect it."""

import argparse
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_port import REPO
from test_torch_port import torch_threads  # noqa: F401  (autouse)

VENDORED = ["CIFAR10", "CIFAR100", "TinyImagenet200", "Imagenet1000"]
LOSSES = ["CrossEntropyLoss", "HardTreeSupLoss", "SoftSegTreeSupLoss", "SoftTreeLoss",
          "SoftTreeSupLoss", "TreeSupLoss", "cross_entropy", "hard_tree_sup_loss",
          "soft_tree_sup_loss"]
# JAX's top-level names with no port counterpart by design (ROADMAP A:
# JTreeArrays is DeviceTreeArrays), and the port's own additions.
JAX_ONLY = {"JTreeArrays"}
PORT_ONLY = {"DeviceTreeArrays", "TaggedOutput", "aot_compile", "export_serving", "load_serving",
             "make_serving_fn", "shard_serving"}


def _imported_names(path):
    """``{name: module}`` of the ``from .module import name`` lines of an
    ``__init__.py``, read by AST (nothing is imported)."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    return {a.asname or a.name: node.module for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.level == 1 for a in node.names}


HIERARCHY = _imported_names("nbdt_tpu/hierarchy/__init__.py")


@pytest.mark.parametrize("name", LOSSES)
def test_loss_names_resolve_from_the_package(name):
    import nbdt_torch
    from nbdt_torch import losses

    assert getattr(nbdt_torch, name) is getattr(losses, name)


@pytest.mark.parametrize("name", sorted(HIERARCHY))
def test_hierarchy_names_resolve_from_the_package(name):
    import importlib

    import nbdt_torch.hierarchy as hierarchy

    module = importlib.import_module(f"nbdt_torch.hierarchy.{HIERARCHY[name]}")
    assert getattr(hierarchy, name) is getattr(module, name)


@pytest.mark.parametrize("path,jax_only,port_only", [
    ("__init__.py", JAX_ONLY, PORT_ONLY), ("hierarchy/__init__.py", set(), set())])
def test_reexported_names_equal_jax_less_the_by_design_list(path, jax_only, port_only):
    jax_names = set(_imported_names(f"nbdt_tpu/{path}"))
    port_names = set(_imported_names(f"nbdt_torch/{path}"))
    assert jax_only <= jax_names and not port_only & jax_names
    assert port_names - port_only == jax_names - jax_only
    assert len(HIERARCHY) == 35


@pytest.fixture(scope="module")
def trees():
    """The four vendored default trees, built by both packages."""
    from nbdt_tpu.tree import Tree as JTree
    from nbdt_torch.tree import Tree

    return {d: (JTree(d), Tree(d)) for d in VENDORED}


@pytest.mark.parametrize("dataset", VENDORED)
def test_node_helpers_match_jax(trees, dataset):
    from nbdt_tpu.tree import Node as JNode
    from nbdt_torch.tree import Node

    jt, tt = trees[dataset]
    assert [n.wnid for n in tt.nodes] == [n.wnid for n in jt.nodes]
    assert [n.class_counts for n in tt.nodes] == [n.class_counts for n in jt.nodes]
    assert Node.dim(tt.inodes) == JNode.dim(jt.inodes) == sum(n.num_children for n in tt.inodes)
    assert Node.dim(tt.inodes[:3]) == JNode.dim(jt.inodes[:3])
    root_t, root_j = tt.root, jt.root
    for leaf in tt.wnids_leaves[::7]:
        assert root_t.wnid_to_class_index(leaf) == root_j.wnid_to_class_index(leaf)
        assert root_t.wnid_to_class_index(leaf) == tt.wnid_to_class_index[leaf]
    assert sum(root_t.class_counts) == len(tt.wnids_leaves)


@pytest.mark.parametrize("dataset,hierarchy", [
    ("CIFAR10", "induced"), ("CIFAR100", "induced"), ("TinyImagenet200", "induced"),
    ("Imagenet1000", "induced-efficientnet_b7b"), ("CIFAR10", "wordnet")])
def test_create_from_args_matches_jax(dataset, hierarchy):
    from nbdt_tpu.tree import Tree as JTree
    from nbdt_torch.tree import Tree

    args = argparse.Namespace(dataset=dataset, path_graph=None, path_wnids=None,
                              hierarchy=hierarchy, extra="ignored")
    classes = [f"c{i}" for i in range(len(JTree(dataset).wnids_leaves))]
    for kw in ({}, {"classes": classes}):
        jt, tt = JTree.create_from_args(args, **kw), Tree.create_from_args(args, **kw)
        assert isinstance(tt, Tree)
        assert (tt.path_graph, tt.path_wnids) == (jt.path_graph, jt.path_wnids)
        assert tt.classes == jt.classes and tt.wnids_leaves == jt.wnids_leaves
        assert [(n.wnid, n.succ) for n in tt.nodes] == [(n.wnid, n.succ) for n in jt.nodes]
    # an explicit graph wins over the hierarchy's name
    args.path_graph, args.hierarchy = jt.path_graph, "no-such-hierarchy"
    assert Tree.create_from_args(args).path_graph == JTree.create_from_args(args).path_graph


@pytest.mark.parametrize("dataset", ["CIFAR10", "CIFAR100"])
def test_remove_node_matches_jax(dataset):
    from nbdt_tpu.hierarchy.digraph import read_graph as jread
    from nbdt_tpu.utils import dataset_to_default_path_graph
    from nbdt_torch.hierarchy.digraph import get_root, read_graph

    path = dataset_to_default_path_graph(dataset)
    jg, tg = jread(path), read_graph(path)
    inner = next(n for n in tg.nodes if tg.succ(n) and tg.pred(n))
    leaf = next(n for n in tg.nodes if not tg.succ(n))
    for node in (inner, leaf, get_root(tg)):  # the root is found before any removal
        jg.remove_node(node)
        tg.remove_node(node)
        assert node not in tg
        assert tg.nodes == jg.nodes
        assert [(tg.succ(n), tg.pred(n)) for n in tg.nodes] == \
            [(jg.succ(n), jg.pred(n)) for n in jg.nodes]
    with pytest.raises(KeyError):
        tg.remove_node(leaf)


def _pixels(x, mean, std):
    """The uint8 codes a normalized batch came from."""
    return np.rint((x * std + mean) * 255).astype(np.uint8)


@pytest.mark.parametrize("pad,shape", [(4, (64, 32, 32, 3)), (0, (5, 7, 9, 3)),
                                       (2, (3, 16, 12, 1))])
def test_apply_augment_numpy_equals_jax_and_the_native_kernel(pad, shape):
    from nbdt_tpu.data.transforms import apply_augment_numpy as japply
    from nbdt_torch import native
    from nbdt_torch.data.transforms import CIFAR_MEAN, CIFAR_STD, apply_augment_numpy

    rng = np.random.RandomState(sum(shape) + pad)
    batch = rng.randint(0, 256, shape).astype(np.uint8)
    c = shape[-1]
    mean, std = CIFAR_MEAN[:c], CIFAR_STD[:c]
    draws = np.random.RandomState(7)
    ys = draws.randint(0, 2 * pad + 1, size=shape[0])
    xs = draws.randint(0, 2 * pad + 1, size=shape[0])
    flips = draws.rand(shape[0]) < 0.5
    got = apply_augment_numpy(batch, pad, ys, xs, flips, mean, std)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, japply(batch, pad, ys, xs, flips, mean, std))
    # The native kernel draws the same offsets and flips from the same seed.
    # It folds the 1/255 into a lookup table, (v / (255 std) - mean / std),
    # so its floats sit within 1e-6 of numpy's (v / 255 - mean) / std; the
    # pixels it picked, read back from either, are the same to the bit.
    kernel = native.augment_batch(batch, pad, mean, std, np.random.RandomState(7))
    assert kernel is not None, native.build_error
    np.testing.assert_allclose(kernel, got, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_pixels(kernel, mean, std), _pixels(got, mean, std))
    padded = np.pad(batch, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    for k in range(shape[0]):  # each image is its padded window, mirrored where flipped
        window = padded[k, ys[k]:ys[k] + shape[1], xs[k]:xs[k] + shape[2]]
        np.testing.assert_array_equal(_pixels(got, mean, std)[k],
                                      window[:, ::-1] if flips[k] else window)


@pytest.mark.parametrize("dataset", VENDORED)
def test_wnid_tables_equal_jax_and_back_get_dataset_wnids(dataset, monkeypatch, tmp_path):
    from nbdt_tpu import assets as jassets
    from nbdt_torch import assets

    table = assets.DATASET_TO_WNIDS[dataset]
    assert table == jassets.DATASET_TO_WNIDS[dataset]
    assert table is getattr(assets, {"CIFAR10": "CIFAR10_WNIDS", "CIFAR100": "CIFAR100_WNIDS",
                                     "TinyImagenet200": "TINYIMAGENET200_WNIDS",
                                     "Imagenet1000": "IMAGENET1000_WNIDS"}[dataset])
    assert assets.get_dataset_wnids(dataset) == jassets.get_dataset_wnids(dataset)
    missing = str(tmp_path / "absent.txt")
    for module in (assets, jassets):
        monkeypatch.setattr(module, "dataset_to_default_path_wnids", lambda d: missing)
    got = assets.get_dataset_wnids(dataset, missing)
    assert got == jassets.get_dataset_wnids(dataset, missing) == table
    assert got is not table  # a copy: callers may edit it
    # past the tables, both fall to the f######## dummies
    assert assets.get_dataset_wnids("ADE20K") == jassets.get_dataset_wnids("ADE20K")


def test_console_scripts_name_a_main():
    """``setup.py`` installs the two hierarchy CLIs beside the port's other
    three, and ships the notebook walkthrough."""
    import importlib

    tree = ast.parse(open(os.path.join(REPO, "setup.py")).read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "setup")
    kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords
          if k.arg in ("entry_points", "package_data")}
    scripts = dict(s.replace(" ", "").split("=") for s in kw["entry_points"]["console_scripts"])
    assert scripts["nbdt-torch-hierarchy"] == "nbdt_torch.bin.nbdt_hierarchy:main"
    assert scripts["nbdt-torch-wnids"] == "nbdt_torch.bin.nbdt_wnids:main"
    for name, target in scripts.items():
        if name.startswith("nbdt-torch"):
            module, func = target.split(":")
            assert callable(getattr(importlib.import_module(module), func)), name
    assert "examples/*.ipynb" in kw["package_data"]["nbdt_torch"]
    assert os.path.exists(os.path.join(REPO, "nbdt_torch/examples/load_pretrained_nbdts.ipynb"))


BLOCKED = ("jax", "jaxlib", "flax", "optax", "nbdt_tpu")


def test_surface_imports_without_jax(tmp_path):
    """Under a ``sys.meta_path`` hook that makes jax, flax, optax and
    nbdt_tpu unimportable: every name of this slice imports from the path a
    user writes, and the tables back ``get_dataset_wnids``."""
    code = f"""
import sys
BLOCKED = {BLOCKED!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {{name}}")
        return None
sys.meta_path.insert(0, Block())
import argparse
import numpy as np
from nbdt_torch import {", ".join(LOSSES)}
import nbdt_torch.hierarchy as hierarchy
from nbdt_torch.hierarchy import generate_hierarchy, write_graph, FakeSynset, MODEL_FC_KEYS
from nbdt_torch.tree import Node, Tree
from nbdt_torch.data.transforms import apply_augment_numpy
from nbdt_torch import assets
from nbdt_torch.bin.nbdt_hierarchy import main as hmain
from nbdt_torch.bin.nbdt_wnids import main as wmain
names = {sorted(HIERARCHY)!r}
assert all(hasattr(hierarchy, n) for n in names)
tree = Tree.create_from_args(argparse.Namespace(dataset="CIFAR100", path_graph=None,
                                                path_wnids=None, hierarchy="induced"))
g = tree.G
g.remove_node(tree.leaves[0].wnid)
assets.dataset_to_default_path_wnids = lambda d: "absent.txt"
print(len(assets.get_dataset_wnids("Imagenet1000")), sum(tree.root.class_counts),
      Node.dim(tree.inodes), tree.root.wnid_to_class_index(tree.wnids_leaves[3]),
      apply_augment_numpy(np.zeros((1, 4, 4, 3), np.uint8), 1, np.array([0]), np.array([2]), np.array([1]),
                          np.zeros(3, np.float32), np.ones(3, np.float32)).shape)
print("loaded", [m for m in sys.modules if m.split(".")[0] in BLOCKED])
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-2] == "1000 100 198 3 (1, 4, 4, 3)"
    assert lines[-1] == "loaded []"
