"""nbdt_torch.tree, hierarchy and utils against nbdt_tpu's: every compiled
TreeArrays field, the graph helpers, the asset paths and the per-leaf
decision steps are equal."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from test_torch_port import tree_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)

TREES = ["synthetic", "dag", "CIFAR10", "CIFAR100", "TinyImagenet200", "Imagenet1000"]


@pytest.mark.parametrize("name", TREES)
def test_tree_arrays_equal(name):
    jtree, ttree = tree_pair(name)
    ja, ta = jtree.arrays, ttree.arrays
    for f in dataclasses.fields(ja):
        a, b = getattr(ja, f.name), getattr(ta, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert ta.is_multipath == (name == "dag")


@pytest.mark.parametrize("name", ["synthetic", "dag", "CIFAR10", "CIFAR100"])
def test_graph_helpers_equal(name):
    """get_roots / get_root / get_depth / get_leaves / get_leaf_to_path and
    the node names agree with nbdt_tpu's on the same graph."""
    import nbdt_tpu.hierarchy.digraph as jd
    import nbdt_torch.hierarchy.digraph as td

    jtree, ttree = tree_pair(name)
    jG, tG = jtree.G, ttree.G
    assert tG.nodes == jG.nodes
    assert all(tG.succ(n) == jG.succ(n) for n in jG.nodes)
    assert list(td.get_roots(tG)) == list(jd.get_roots(jG))
    assert td.get_root(tG) == jd.get_root(jG)
    assert td.get_depth(tG) == jd.get_depth(jG)
    assert list(td.get_leaves(tG)) == list(jd.get_leaves(jG))
    assert td.get_leaf_to_path(tG) == jd.get_leaf_to_path(jG)
    assert [n.name for n in ttree.nodes] == [n.name for n in jtree.nodes]


def test_utils_match():
    """Asset paths, wnid lists, class registries and tensor coercion."""
    import nbdt_tpu.assets as ja
    import nbdt_tpu.utils as ju
    import torch

    import nbdt_torch.assets as ta
    import nbdt_torch.utils as tu

    for dataset in ("CIFAR10", "CIFAR100", "TinyImagenet200", "Imagenet1000"):
        for fn in ("dataset_to_default_path_graph", "dataset_to_default_path_wnids"):
            ours, theirs = (Path(getattr(m, fn)(dataset)) for m in (tu, ju))
            assert ours.read_text() == theirs.read_text()
        assert ta.get_dataset_wnids(dataset) == ja.get_dataset_wnids(dataset)
        assert tu.DATASET_TO_NUM_CLASSES[dataset] == ju.DATASET_TO_NUM_CLASSES[dataset]
    assert tu.DATASET_TO_CLASSES["CIFAR10"] == list(ju.DATASET_TO_CLASSES["CIFAR10"])
    x = np.random.RandomState(0).randn(2, 4, 4, 3).astype(np.float32)
    got = tu.coerce_tensor(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), ju.coerce_tensor(x))
    np.testing.assert_array_equal(tu.uncoerce_tensor(got, x.shape).numpy(), x)
    labels = np.zeros((2, 4, 4), np.int64)
    assert tuple(tu.coerce_tensor(torch.as_tensor(labels), is_label=True).shape) == (32, 1)


@pytest.mark.parametrize("name", ["synthetic", "dag", "CIFAR10"])
def test_leaf_to_steps_and_names_equal(name):
    jtree, ttree = tree_pair(name)
    assert [n.name for n in jtree.nodes] == [n.name for n in ttree.nodes]
    assert [n.wnid for n in jtree.inodes] == [n.wnid for n in ttree.inodes]
    js, ts = jtree.get_leaf_to_steps(), ttree.get_leaf_to_steps()
    assert list(js) == list(ts)
    for leaf in js:
        assert [(s["node"].wnid, s["name"], s["next_index"]) for s in js[leaf]] == [
            (s["node"].wnid, s["name"], s["next_index"]) for s in ts[leaf]
        ]
