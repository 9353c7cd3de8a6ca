"""nbdt_torch's hierarchies against nbdt_tpu's: the same class centers give
the same ward merges and a byte-identical graph JSON (induced, pruned,
written), offline and under a mini WordNet corpus that names the parents by
common hypernyms; ``Tree.update_from_model`` regenerates the same tree from
a live model. The mini-corpora derived from the vendored WordNet graphs,
the Superclass hypernym mapping, the random and WordNet builders,
augmenting, ``generate_hierarchy``'s three methods, the HTML visualiser and
the two hierarchy CLIs write what JAX's write. Every file goes to
``tmp_path``."""

import os

import numpy as np
import pytest

from test_torch_port import torch_threads  # noqa: F401  (autouse)


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
    path = generate_hierarchy("CIFAR10", method="random", hierarchies_root=str(tmp_path))
    assert path == str(tmp_path / "CIFAR10" / "graph-random.json")
    with pytest.raises(NotImplementedError, match="foo"):
        generate_hierarchy("CIFAR10", method="foo", hierarchies_root=str(tmp_path))
    from nbdt_tpu.hierarchy.generate import generate_graph_fname as jfname

    for kw in (dict(method="induced"), dict(method="induced", arch="ResNet18"),
               dict(method="induced", checkpoint="ckpt-CIFAR10-ResNet18-induced-X.pth"),
               dict(method="induced", branching_factor=3, no_prune=True),
               dict(method="random", seed=2, extra=10)):
        assert generate_graph_fname(**kw) == jfname(**kw)


WORDNET_GRAPHS = ["CIFAR10", "CIFAR100", "TinyImagenet200"]


def _graph(dataset, hierarchy="wordnet"):
    from nbdt_torch.utils import hierarchy_to_path_graph

    return hierarchy_to_path_graph(dataset, hierarchy)


@pytest.fixture
def corpus():
    """Installs a mini-corpus in both packages (``corpus(source)``) and
    clears both afterwards."""
    from nbdt_tpu.hierarchy import wnid as jwnid

    from nbdt_torch.hierarchy import wnid as twnid

    def install(source):
        jwnid.install_mini_corpus(source)
        twnid.install_mini_corpus(source)

    yield install
    jwnid.clear_mini_corpus()
    twnid.clear_mini_corpus()


@pytest.mark.parametrize("dataset", WORDNET_GRAPHS)
def test_mini_corpus_from_graph_json_matches_jax(dataset):
    """The table derived from each vendored WordNet graph is JAX's, and the
    port installs a graph JSON given by path as that table (its chains
    resolve: 'airplane' climbs to 'entity')."""
    from nbdt_tpu.hierarchy import wnid as jwnid

    from nbdt_torch.hierarchy import wnid as twnid

    table = twnid.mini_corpus_from_graph_json(_graph(dataset))
    assert table == jwnid.mini_corpus_from_graph_json(_graph(dataset))
    twnid.install_mini_corpus(_graph(dataset))
    try:
        assert twnid._MINI_CORPUS == table
        wnid = next(w for w in table if table[w]["hypernyms"])
        synset = twnid.wnid_to_synset(wnid)
        assert isinstance(synset, twnid.MiniSynset) and synset.hypernyms()
        assert synset.definition() == "(mini-corpus)"
    finally:
        twnid.clear_mini_corpus()


def test_fake_synsets_have_no_hypernyms():
    from nbdt_torch.hierarchy.wnid import FakeSynset, wnid_to_synset

    s = wnid_to_synset("n02691156")  # no corpus here
    assert isinstance(s, FakeSynset) and s.hypernyms() == []
    assert s.definition() == "(generated)" and s.name() == "(generated)"


SUPERCLASSES = [["n00015388", "n04524313"], ["n02691156", "n02958343"], ["n01317541"]]


@pytest.mark.parametrize("source", ["none", "table", "graph"])
@pytest.mark.parametrize("dataset", ["CIFAR10", "CIFAR100"])
def test_superclass_mapping_matches_jax(corpus, source, dataset):
    """``Superclass.build_mapping`` (the WordNet hypernym closure) gives
    JAX's mapping with no corpus (each wnid maps only to itself), under a
    table and under a vendored graph given by path; and the
    VisualizeDecisionNode superclass zeroing reaches it."""
    from nbdt_tpu.analysis import Superclass as JSuperclass

    from nbdt_torch.analysis import Superclass as TSuperclass
    from nbdt_torch.assets import get_dataset_wnids
    from nbdt_torch.hierarchy.wnid import mini_corpus_from_graph_json

    if source == "table":
        corpus(mini_corpus_from_graph_json(_graph(dataset)))
    elif source == "graph":
        corpus(_graph(dataset))
    wnids = get_dataset_wnids(dataset)
    for sup in SUPERCLASSES:
        jm, jn = JSuperclass.build_mapping(wnids, sup)
        tm, tn = TSuperclass.build_mapping(wnids, sup)
        np.testing.assert_array_equal(tm, jm)
        assert dict(tn) == dict(jn)
    if source != "none":  # 'animal' and 'vehicle' capture classes through hypernyms
        tm, _ = TSuperclass.build_mapping(wnids, SUPERCLASSES[0])
        assert (tm >= 0).sum() == {"CIFAR10": 8, "CIFAR100": 44}[dataset]


@pytest.mark.parametrize("dataset,seed,branching", [
    ("CIFAR10", 0, 2), ("CIFAR10", 3, 3), ("CIFAR100", -1, 2), ("TinyImagenet200", 7, 4)])
def test_random_graph_matches_jax(dataset, seed, branching):
    from nbdt_tpu.hierarchy.build import build_random_graph as jbuild
    from nbdt_tpu.hierarchy.digraph import node_link_data as jdata

    from nbdt_torch.hierarchy.build import build_random_graph
    from nbdt_torch.hierarchy.digraph import node_link_data

    wnids = _both_wnids(dataset, None)
    assert node_link_data(build_random_graph(wnids, seed, branching)) == \
        jdata(jbuild(wnids, seed, branching))


@pytest.mark.parametrize("dataset", ["CIFAR10", "CIFAR100"])
def test_wordnet_graph_and_augment_match_jax(corpus, dataset):
    """Under a dataset's mini-corpus: the WordNet builder single- and
    multi-path, pruning, and augmenting by 20% give JAX's node-link data;
    pruned, the single-path graph is the vendored one, links in order."""
    import json

    from nbdt_tpu.hierarchy import build as jb
    from nbdt_tpu.hierarchy.digraph import node_link_data as jdata

    from nbdt_torch.hierarchy import build as tb
    from nbdt_torch.hierarchy.digraph import node_link_data

    corpus(_graph(dataset))
    wnids = _both_wnids(dataset, None)
    for multi in (False, True):
        assert node_link_data(tb.build_minimal_wordnet_graph(wnids, multi)) == \
            jdata(jb.build_minimal_wordnet_graph(wnids, multi))
    G = tb.prune_single_successor_nodes(tb.build_minimal_wordnet_graph(wnids))
    jG = jb.prune_single_successor_nodes(jb.build_minimal_wordnet_graph(wnids))
    shipped = json.load(open(_graph(dataset)))
    data = node_link_data(G)
    assert [(l["source"], l["target"]) for l in data["links"]] == \
        [(l["source"], l["target"]) for l in shipped["links"]]
    assert {n["id"]: n for n in data["nodes"]} == {n["id"]: n for n in shipped["nodes"]}
    got, jgot = tb.augment_graph(G, 20, True), jb.augment_graph(jG, 20, True)
    assert node_link_data(got[0]) == jdata(jgot[0]) and got[1:] == jgot[1:]
    assert got[1] > 0


def test_wordnet_builder_needs_a_corpus():
    from nbdt_torch.hierarchy.build import build_minimal_wordnet_graph

    with pytest.raises(RuntimeError, match="mini-corpus"):
        build_minimal_wordnet_graph(["n02691156"])


GENERATE = [dict(method="random"), dict(method="random", seed=2, branching_factor=3),
            dict(method="random", no_prune=True), dict(method="wordnet"),
            dict(method="wordnet", no_prune=True), dict(method="wordnet", extra=15),
            dict(method="wordnet", multi_path=True)]


@pytest.mark.parametrize("kw", GENERATE, ids=lambda kw: "-".join(map(str, kw.values())))
def test_generate_hierarchy_methods_match_jax(tmp_path, corpus, kw):
    """``generate_hierarchy`` writes JAX's file name and bytes for the
    random and WordNet methods (under the CIFAR10 mini-corpus); the port's
    ``multi_path`` is the JAX package's ``single_path``."""
    from nbdt_tpu.hierarchy.generate import generate_hierarchy as jgen

    from nbdt_torch.hierarchy.generate import generate_hierarchy as tgen

    corpus(_graph("CIFAR10"))
    jkw = dict(kw)
    if "multi_path" in jkw:
        jkw["single_path"] = jkw.pop("multi_path")
    jp = jgen("CIFAR10", hierarchies_root=str(tmp_path / "jax"), **jkw)
    tp = tgen("CIFAR10", hierarchies_root=str(tmp_path / "torch"), **kw)
    assert os.path.relpath(tp, tmp_path / "torch") == os.path.relpath(jp, tmp_path / "jax")
    assert open(tp, "rb").read() == open(jp, "rb").read()


VIS = [
    {},
    dict(color_path_to="n02691156", edge_probs={"n02691156": 0.25, "n03125870": 0.8}),
    dict(sublabels=True, fake_sublabels=True, color_leaves=False, theme="dark", zoom=1.5),
    dict(vis_root="n01471682", hide=["n01503061"], force_labels_left=["cat"], curved=False),
    dict(color_nodes=["n02958343"], node_conf=[("n02691156", "name", "renamed"),
                                               ("n02691156", "meta.k", 3)],
         scale=2.0, root_y=120, width=900, height=600, margin_top=5, margin_left=7,
         above_dy=2, below_dy=3),
    dict(collapse=["n01471682"], _print=True, gradient=True, text_rect="rgba(255,255,255,0.8)",
         stroke_width=0.45, color="blue-green"),
    dict(color="blue", colormap="no-such.png"),
    dict(color="blue-minimal", root_y="null"),
]


@pytest.mark.parametrize("kw", VIS, ids=range(len(VIS)))
def test_vis_html_byte_identical(tmp_path, kw):
    """The HTML of the vendored CIFAR10 WordNet graph is JAX's, byte for
    byte, across the option family of tests/test_hierarchy.py's vis tests;
    ``Tree.visualize`` writes the same page."""
    from nbdt_tpu.hierarchy.digraph import read_graph as jread
    from nbdt_tpu.hierarchy.vis import generate_hierarchy_vis_from as jvis

    from nbdt_torch.hierarchy.digraph import read_graph
    from nbdt_torch.hierarchy.vis import generate_hierarchy_vis_from
    from nbdt_torch.tree import Tree

    jp = jvis(jread(_graph("CIFAR10")), dataset="CIFAR10", path_html=str(tmp_path / "j.html"),
              **kw)
    tp = generate_hierarchy_vis_from(read_graph(_graph("CIFAR10")), dataset="CIFAR10",
                                     path_html=str(tmp_path / "t" / "t.html"), **kw)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    vp = Tree("CIFAR10", hierarchy="wordnet").visualize(str(tmp_path / "v.html"), **kw)
    assert open(vp, "rb").read() == open(jp, "rb").read()


def _run_clis(jmain, tmain, args, jargs=(), targs=()):
    """Both CLIs on ``args``, each with its own output roots."""
    from nbdt_tpu.hierarchy import wnid as jwnid

    from nbdt_torch.hierarchy import wnid as twnid

    try:
        jmain([*args, *jargs])
        tmain([*args, *targs])
    finally:
        jwnid.clear_mini_corpus()
        twnid.clear_mini_corpus()


@pytest.mark.parametrize("method", ["random", "wordnet", "induced"])
def test_nbdt_hierarchy_cli_matches_jax(tmp_path, method):
    """``python -m nbdt_torch.bin.nbdt_hierarchy`` writes the JAX CLI's
    graph, check report and HTML: random; WordNet under ``--mini-corpus``;
    induced from one ``.pth`` (a JAX ResNet10 init converted by
    ``state_dict_from_flax``)."""
    from nbdt_tpu.bin.nbdt_hierarchy import main as jmain
    from nbdt_tpu.models import init_model

    from nbdt_torch.bin.nbdt_hierarchy import main as tmain
    from nbdt_torch.models import state_dict_from_flax

    args = ["--dataset", "CIFAR10", "--method", method, "--vis-sublabels"]
    name = {"random": "graph-random", "wordnet": "graph-wordnet"}.get(method)
    if method == "wordnet":
        args += ["--mini-corpus", _graph("CIFAR10")]
    if method == "induced":
        import torch

        _, variables = init_model("ResNet10", 10, (16, 16, 3))
        pth = tmp_path / "ckpt-CIFAR10-ResNet10.pth"
        torch.save(state_dict_from_flax(variables, "ResNet10"), pth)
        args += ["--checkpoint", str(pth)]
        name = "graph-induced-ResNet10"  # the checkpoint's name without "ckpt-<dataset>"
    out = {}
    for side in ("jax", "torch"):
        out[side] = [f"--hierarchies-root", str(tmp_path / side / "h"),
                     "--vis-out-dir", str(tmp_path / side / "vis")]
    _run_clis(jmain, tmain, args, [*out["jax"], "--platform", "cpu"],
              [*out["torch"], "--device", "cpu"])
    for rel in (f"h/CIFAR10/{name}.json", f"vis/{name}.html"):
        t, j = tmp_path / "torch" / rel, tmp_path / "jax" / rel
        assert t.exists() and open(t, "rb").read() == open(j, "rb").read(), rel


def test_nbdt_hierarchy_cli_refuses_what_it_cannot_do(tmp_path):
    from nbdt_torch.bin.nbdt_hierarchy import main

    with pytest.raises(SystemExit, match="--arch or --checkpoint"):
        main(["--method", "induced", "--no-vis", "--hierarchies-root", str(tmp_path)])
    with pytest.raises(SystemExit):  # a vendored graph is not overwritten
        main(["--method", "random", "--path", _graph("CIFAR10", "induced"), "--no-vis"])


@pytest.mark.parametrize("extra", [[], ["--classes", "airplane", "Lawn Mower", "zebra-fish"],
                                   ["--dataset", "Custom", "--classes", "a", "b"]])
def test_nbdt_wnids_cli_matches_jax(tmp_path, monkeypatch, extra):
    """``python -m nbdt_torch.bin.nbdt_wnids`` writes the JAX CLI's wnid
    list where no WordNet corpus can be had (the JAX CLI's download is made
    to fail, and the port never downloads): the vendored CIFAR10 list, else
    FakeSynset wnids in class order."""
    import nltk

    import nbdt_tpu.hierarchy.wnid as jwnid
    from nbdt_tpu.bin.nbdt_wnids import main as jmain

    from nbdt_torch.bin.nbdt_wnids import main as tmain

    def no_download(*a, **k):
        raise OSError("no network")

    monkeypatch.setattr(nltk, "download", no_download)
    monkeypatch.setattr(jwnid, "maybe_install_wordnet", jwnid.wordnet_available)
    _run_clis(jmain, tmain, extra, ["--root", str(tmp_path / "jax")],
              ["--root", str(tmp_path / "torch")])
    name = (extra[1] if extra and extra[0] == "--dataset" else "CIFAR10") + ".txt"
    got = open(tmp_path / "torch" / name).read()
    assert got == open(tmp_path / "jax" / name).read()
    if not extra:
        assert got.split("\n")[0] == "n02691156"
    else:
        assert all(w.startswith("f") for w in got.split("\n"))
    with pytest.raises(SystemExit, match="vendored"):
        from nbdt_torch.utils import ASSETS_ROOT

        tmain(["--root", str(ASSETS_ROOT / "wnids")])
