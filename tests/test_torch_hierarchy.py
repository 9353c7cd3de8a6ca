"""nbdt_torch's hierarchy induction against nbdt_tpu's: the same class
centers give the same ward merges and a byte-identical graph JSON (induced,
pruned, written), offline and under a mini WordNet corpus that names the
parents by common hypernyms; ``Tree.update_from_model`` regenerates the same
tree from a live model. Every file goes to ``tmp_path``."""

import numpy as np
import pytest


def _centers(C, D, seed):
    return np.random.RandomState(seed).randn(C, D).astype(np.float32)


def _both_wnids(dataset, C):
    from nbdt_tpu.assets import get_dataset_wnids as jw

    from nbdt_torch.assets import get_dataset_wnids as tw

    j, t = jw(dataset)[:C], tw(dataset)[:C]
    assert j == t
    return t


@pytest.mark.parametrize("C,D,seed", [(10, 512, 0), (100, 512, 1), (7, 16, 2), (200, 64, 3)])
def test_ward_children_match(C, D, seed):
    from nbdt_tpu.hierarchy.cluster import _ward_children_numpy, ward_children as jward

    from nbdt_torch.hierarchy.cluster import ward_children as tward

    X = _centers(C, D, seed)
    np.testing.assert_array_equal(tward(X), jward(X))
    np.testing.assert_array_equal(tward(X), _ward_children_numpy(X.astype(np.float64)))


@pytest.mark.parametrize("dataset,C,seed", [("CIFAR10", 10, 0), ("CIFAR100", 100, 1),
                                            ("TinyImagenet200", 200, 4)])
def test_generate_induced_json_byte_identical(tmp_path, dataset, C, seed):
    from nbdt_tpu.hierarchy.generate import generate_hierarchy as jgen

    from nbdt_torch.hierarchy.generate import generate_hierarchy as tgen

    centers = _centers(C, 512, seed)
    wnids = _both_wnids(dataset, C)
    jp = jgen(dataset, method="induced", centers=centers, wnids=wnids, arch="ResNet18",
              hierarchies_root=str(tmp_path / "jax"))
    tp = tgen(dataset, method="induced", centers=centers, wnids=wnids, arch="ResNet18",
              hierarchies_root=str(tmp_path / "torch"))
    assert tp.endswith(f"{dataset}/graph-induced-ResNet18.json")
    assert open(tp, "rb").read() == open(jp, "rb").read()


def test_generate_from_a_resnet10_init_byte_identical(tmp_path):
    """Centers from the classifier of one ResNet10 init, the JAX package's
    from its flax params and the port's from the converted module."""
    from test_torch_port import resnet_pair

    from nbdt_tpu.hierarchy.generate import generate_hierarchy as jgen

    from nbdt_torch.hierarchy.generate import generate_hierarchy as tgen

    _, variables, port = resnet_pair("ResNet10", 10, img=16, seed=3)
    jp = jgen("CIFAR10", method="induced", params=variables["params"], arch="ResNet10",
              hierarchies_root=str(tmp_path / "jax"))
    tp = tgen("CIFAR10", method="induced", model=port, arch="ResNet10",
              hierarchies_root=str(tmp_path / "torch"))
    assert open(tp, "rb").read() == open(jp, "rb").read()
    # and from the state dict's "linear.weight", as a checkpoint gives it
    sp = tgen("CIFAR10", state_dict=port.state_dict(), path=str(tmp_path / "sd.json"))
    assert open(sp, "rb").read() == open(jp, "rb").read()


def test_generate_with_mini_corpus_names_parents_alike(tmp_path):
    """Under one mini WordNet (derived from the vendored CIFAR10 WordNet
    graph), both packages name induced parents by the deepest unused common
    hypernym, and write the same bytes; without pruning too."""
    from nbdt_tpu.hierarchy import wnid as jwnid
    from nbdt_tpu.hierarchy.generate import generate_hierarchy as jgen

    from nbdt_torch.hierarchy import wnid as twnid
    from nbdt_torch.hierarchy.generate import generate_hierarchy as tgen

    table = jwnid.mini_corpus_from_graph_json(
        jwnid.__file__.replace("hierarchy/wnid.py", "hierarchies/CIFAR10/graph-wordnet.json"))
    wnids = _both_wnids("CIFAR10", 10)
    centers = _centers(10, 64, 5)
    jwnid.install_mini_corpus(table)
    twnid.install_mini_corpus(table)
    try:
        for no_prune in (False, True):
            jp = jgen("CIFAR10", centers=centers, wnids=wnids, no_prune=no_prune,
                      hierarchies_root=str(tmp_path / "jax"))
            tp = tgen("CIFAR10", centers=centers, wnids=wnids, no_prune=no_prune,
                      hierarchies_root=str(tmp_path / "torch"))
            data = open(tp, "rb").read()
            assert data == open(jp, "rb").read()
            assert b'"n00001740"' in data  # WordNet's "entity" names a parent
    finally:
        jwnid.clear_mini_corpus()
        twnid.clear_mini_corpus()


def test_update_from_model_matches(tmp_path):
    """The port's Tree.update_from_model (a live module) against the JAX
    package's (its params): the same regenerated graph and tree arrays."""
    from test_torch_port import resnet_pair

    from nbdt_tpu.tree import Tree as JTree

    from nbdt_torch.tree import Tree as TTree

    _, variables, port = resnet_pair("ResNet10", 10, img=16, seed=4)
    jtree, ttree = JTree("CIFAR10"), TTree("CIFAR10")
    jtree.update_from_model(variables["params"], "ResNet10", "CIFAR10",
                            path_graph=str(tmp_path / "j" / "graph-epoch3.json"))
    ttree.update_from_model(port, "ResNet10", "CIFAR10",
                            path_graph=str(tmp_path / "t" / "graph-epoch3.json"))
    assert ttree.path_graph.endswith("t/graph-epoch3.json")
    assert open(ttree.path_graph, "rb").read() == open(jtree.path_graph, "rb").read()
    ja, ta = jtree.arrays, ttree.arrays
    for field in ("membership", "under", "child_mask", "target_child", "child_next"):
        np.testing.assert_array_equal(getattr(ta, field), getattr(ja, field))
    assert ta.wnids_inodes == ja.wnids_inodes


def test_generate_refuses_vendored_files_and_other_methods(tmp_path):
    from nbdt_torch.hierarchy.generate import generate_hierarchy, generate_graph_fname
    from nbdt_torch.utils import ASSETS_ROOT

    centers = _centers(10, 8, 0)
    with pytest.raises(FileExistsError, match="vendored"):
        generate_hierarchy("CIFAR10", centers=centers,
                           path=str(ASSETS_ROOT / "hierarchies/CIFAR10/graph-induced.json"))
    with pytest.raises(NotImplementedError, match="A9"):
        generate_hierarchy("CIFAR10", method="random", centers=centers,
                           hierarchies_root=str(tmp_path))
    from nbdt_tpu.hierarchy.generate import generate_graph_fname as jfname

    for kw in (dict(method="induced"), dict(method="induced", arch="ResNet18"),
               dict(method="induced", checkpoint="ckpt-CIFAR10-ResNet18-induced-X.pth"),
               dict(method="induced", branching_factor=3, no_prune=True),
               dict(method="random", seed=2, extra=10)):
        assert generate_graph_fname(**kw) == jfname(**kw)
