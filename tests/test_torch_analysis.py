"""nbdt_torch.analysis against nbdt_tpu.analysis on the same inputs.

Every ported analyzer takes the same seeded logits, targets and [0, 1]
images through the JAX analyzer and the port's (rules on the CPU): the
accuracies and hit counts, the confusion matrix, the ignored count, the
scores (within 1e-5: the rules sum in another order), the order of the
saved samples, and the JPEGs written are held equal. ``device_eval``'s
counts equal the host path's, in the trainer too. ``build_analyzer``
constructs all fourteen. ``Superclass`` and ``SuperclassNBDT`` score the
same logits as JAX's under ``mapping=``, ``mapping_test=``, a mini-corpus
and ``dataset_test``; ``VisualizeHierarchyInference`` writes JAX's pages.
Last, the CLI's ``--eval --checkpoint-path --analysis`` on a tiny WRN
prints the NBDT accuracy that the JAX CLI prints, and the superclass
accuracies of a zero-shot eval on CIFAR100's classes.
"""

import argparse
import os
import re

import numpy as np
import pytest
import torch

from test_torch_port import tree_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)

PORTED = ["Noop", "ConfusionMatrix", "IgnoredSamples", "HardEmbeddedDecisionRules",
          "SoftEmbeddedDecisionRules", "Entropy", "VisualizeDecisionNode", "NBDTEntropyMaxMin",
          "NBDTEntropyBottom", "TopEntropy", "TopDifference"]
SCORE_SAVERS = ["Entropy", "VisualizeDecisionNode", "NBDTEntropyMaxMin", "NBDTEntropyBottom",
                "TopEntropy", "TopDifference"]


def _inputs(C=7, batch=24, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(batch, C).astype(np.float32) * 2
    targets = rng.randint(0, C, batch)
    images = rng.rand(batch, 8, 8, 3).astype(np.float32)
    return logits, targets, images


def _pair(name, tmp_path=None, **kw):
    """(JAX analyzer, port analyzer) of one name on the synthetic tree."""
    import nbdt_tpu.analysis as ja

    import nbdt_torch.analysis as ta

    jtree, ttree = tree_pair("synthetic")
    jkw, tkw = dict(kw), dict(kw)
    if name in ("Noop", "ConfusionMatrix", "IgnoredSamples"):
        jkw["classes"] = tkw["classes"] = jtree.classes
    else:
        if name not in ("Entropy", "TopEntropy", "TopDifference"):
            jkw["tree"], tkw["tree"] = jtree, ttree
            tkw["device"] = "cpu"
        if name == "VisualizeDecisionNode":
            jkw["visualize_decision_node_wnid"] = tkw["visualize_decision_node_wnid"] = \
                jtree.wnids_leaves[3]
        if name in SCORE_SAVERS:
            pattern = "{epoch}/img-{suffix}-{i}-{score:.2e}.jpg"
            jkw.update(save_k=4, path=str(tmp_path / "jax" / pattern))
            tkw.update(save_k=4, path=str(tmp_path / "port" / pattern))
    return getattr(ja, name)(**jkw), getattr(ta, name)(**tkw)


def _run(an, batches, train=True):
    """The trainer's lifecycle over a train pass and a test pass."""
    an.start_epoch(0)
    if train:
        an.start_train(0)
        an.update_batch(*batches[0])
        an.end_train(0)
    an.start_test(0)
    for b in batches[1:]:
        an.update_batch(*b)
    an.end_test(0)
    an.end_epoch(0)


@pytest.mark.parametrize("name", PORTED)
def test_analyzer_matches_jax(name, tmp_path, capsys):
    j, t = _pair(name, tmp_path)
    batches = [_inputs(seed=s) for s in range(3)]
    if name == "IgnoredSamples":
        for logits, _, _ in batches:
            logits[::5, 0] = -1
    # the counters of these two exist from start_test on, in both packages
    train = name not in ("ConfusionMatrix", "IgnoredSamples")
    _run(j, batches, train)
    jout = capsys.readouterr().out
    # the port takes CPU tensors as readily as numpy
    _run(t, [(torch.as_tensor(x), torch.as_tensor(y), im) for x, y, im in batches], train)
    tout = capsys.readouterr().out
    assert t.epoch == j.epoch == 0
    if name == "ConfusionMatrix":
        np.testing.assert_array_equal(t.m, j.m)
        np.testing.assert_array_equal(t.recall(), j.recall())
        np.testing.assert_array_equal(t.precision(), j.precision())
    if name == "IgnoredSamples":
        assert t.ignored == j.ignored == 10
    if name.endswith("DecisionRules"):
        assert (t.metric.correct, t.metric.total) == (j.metric.correct, j.metric.total)
        assert t.metric.total == 48 and t.accuracy == j.accuracy == t.best_accuracy
    if name in SCORE_SAVERS:
        for got, want in ((t.max, j.max), (t.min, j.min)):
            assert len(got) == len(want) == 4
            np.testing.assert_allclose([s for _, _, s in got], [s for _, _, s in want],
                                       rtol=1e-5, atol=1e-6)
            for (go, gi, _), (wo, wi, _) in zip(got, want):  # the same samples, in order
                np.testing.assert_array_equal(go, wo)
                np.testing.assert_array_equal(gi, wi)
        files = {}
        for side in ("jax", "port"):
            root = tmp_path / side / "0"
            files[side] = {re.sub(r"-[^-]*\.jpg$", "", f): (root / f).read_bytes()
                           for f in sorted(os.listdir(root))}
        assert files["port"] == files["jax"] and len(files["jax"]) == 8
    if name.startswith("Entropy") or name == "TopEntropy":
        np.testing.assert_allclose([t.avg, t.std, t.i], [j.avg, j.std, j.i], rtol=1e-6)
    # the printed report, numbers and all (saved-image paths differ by side)
    strip = lambda s: re.sub(r"in \S+", "in <dir>", s)  # noqa: E731
    assert strip(tout) == strip(jout)


def test_score_save_pixel_contract(tmp_path):
    """Float images outside [0, 1] are refused at the dump, as in JAX; uint8
    is written as it is."""
    import nbdt_tpu.analysis as ja

    import nbdt_torch.analysis as ta

    logits, targets, images = _inputs()
    for mod, side in ((ja, "jax"), (ta, "port")):
        an = mod.TopDifference(classes=list("abcdefg"), save_k=2,
                               path=str(tmp_path / side / "{epoch}/i-{suffix}-{i}.jpg"))
        an.start_epoch(0)
        an.start_test(0)
        an.update_batch(logits, targets, (images - 0.5) * 4)
        with pytest.raises(ValueError, match="outside"):
            an.end_test(0)
        an.start_test(0)
        an.update_batch(logits, targets, (images * 255).astype(np.uint8))
        an.end_test(0)
    assert sorted(os.listdir(tmp_path / "port" / "0")) == sorted(os.listdir(tmp_path / "jax" / "0"))


@pytest.mark.parametrize("kind", ["Soft", "Hard"])
def test_device_eval_counts_equal_the_host_path(kind):
    """``device_eval`` gives the rules' pure forward and k: its top-k hits on
    a batch equal the host path's (and JAX's device_eval), and subclasses
    with host work of their own get None."""
    import jax.numpy as jnp

    j, t = _pair(f"{kind}EmbeddedDecisionRules")
    logits, targets, _ = _inputs(batch=64)
    fwd, k = t.device_eval()
    assert k == 1 and t.device_eval()[0] is fwd
    hits = int((fwd(torch.as_tensor(logits)).argmax(1) == torch.as_tensor(targets)).sum())
    jfwd, _ = j.device_eval()
    jhits = int((np.asarray(jfwd(jnp.asarray(logits))).argmax(1) == targets).sum())
    t.start_test(0)
    t.update_batch(logits, targets)
    assert hits == jhits == t.metric.correct and t.metric.total == 64

    class HostOnly(type(t)):
        def _update_batch(self, outputs, targets):
            return super()._update_batch(outputs, targets)

    assert HostOnly(tree=t.rules.tree, device="cpu").device_eval() is None


def test_trainer_counts_the_nbdt_accuracy_on_the_device_as_on_the_host():
    """Trainer.evaluate with a DecisionRules analyzer counts the NBDT hits
    beside the backbone's (device_eval); the same analyzer forced onto the
    host loop reports the same accuracy, and so does the JAX analyzer on
    the same eval logits."""
    import nbdt_tpu.analysis as ja

    import nbdt_torch.analysis as ta
    from nbdt_torch.data import DataLoader, SyntheticDataset
    from nbdt_torch.models import WRN
    from nbdt_torch.trainer import TrainConfig, Trainer, make_eval_step

    jtree, ttree = tree_pair("synthetic")
    torch.manual_seed(0)
    model = WRN(10, 1, 7)
    ds = SyntheticDataset(7, size=20, image_size=16, seed=1)
    loader = DataLoader(ds, 8, transform=ds.transform_val(), drop_last=False, pad_last=True)

    class HostLoop(ta.SoftEmbeddedDecisionRules):
        def _update_batch(self, outputs, targets):
            return super()._update_batch(outputs, targets)

    accs = []
    for cls in (ta.SoftEmbeddedDecisionRules, HostLoop):
        an = cls(tree=ttree, device="cpu")
        tr = Trainer(TrainConfig(batch_size=8, loss="SoftTreeSupLoss"), model, loader, loader,
                     tree=ttree, analyzer=an, device="cpu")
        tr.evaluate(0, checkpoint=False)
        accs.append((an.metric.correct, an.metric.total))
    step = make_eval_step(tr.model, torch.device("cpu"))
    jan = ja.SoftEmbeddedDecisionRules(tree=jtree)
    jan.start_test(0)
    for x, y, v in loader:
        jan.update_batch(step(torch.as_tensor(x)).numpy()[v], np.asarray(y)[v])
    assert accs[0] == accs[1] == (jan.metric.correct, jan.metric.total)
    assert accs[0][1] == 20


def _corpus_table():
    """The mini-corpora of the vendored CIFAR10 and CIFAR100 WordNet graphs,
    merged (they agree on every wnid they share)."""
    from nbdt_torch.hierarchy.wnid import mini_corpus_from_graph_json
    from nbdt_torch.utils import hierarchy_to_path_graph

    table = {}
    for dataset in ("CIFAR10", "CIFAR100"):
        table.update(mini_corpus_from_graph_json(hierarchy_to_path_graph(dataset, "wordnet")))
    return table


@pytest.fixture
def corpus():
    from nbdt_tpu.hierarchy import wnid as jwnid

    from nbdt_torch.hierarchy import wnid as twnid

    table = _corpus_table()
    jwnid.install_mini_corpus(table)
    twnid.install_mini_corpus(table)
    yield table
    jwnid.clear_mini_corpus()
    twnid.clear_mini_corpus()


SUPERCLASS_MODES = ["mapping", "mapping_test", "corpus", "dataset_test"]


@pytest.mark.parametrize("mode", SUPERCLASS_MODES)
@pytest.mark.parametrize("name", ["Superclass", "SuperclassNBDT"])
def test_superclass_analyzers_match_jax(request, name, mode, capsys):
    """The same logits and targets through JAX's analyzer and the port's:
    ``forward`` gives the same predicted and target superclasses, and the
    lifecycle the same correct/total and accuracy. ``mapping`` maps the
    synthetic tree's leaves onto two superclasses; ``mapping_test`` takes
    one class out of the prediction space; ``corpus`` maps the CIFAR10
    WordNet tree's leaves onto 'animal' and 'vehicle' through the
    mini-corpus; ``dataset_test`` scores CIFAR100 targets against CIFAR10
    predictions (the CLI's zero-shot eval)."""
    import nbdt_tpu.analysis as ja

    import nbdt_torch.analysis as ta

    if mode in ("mapping", "mapping_test"):
        jtree, ttree = tree_pair("synthetic")
        wnids = ttree.wnids_leaves
        mapping = {w: i % 2 for i, w in enumerate(wnids)}
        kw = dict(superclass_wnids=["a", "b"], mapping=mapping)
        if mode == "mapping_test":
            kw["mapping"] = dict(mapping, **{wnids[0]: -1})
            kw["mapping_test"] = mapping
        n_test = len(wnids)
    else:
        request.getfixturevalue("corpus")
        jtree, ttree = tree_pair("CIFAR10-wordnet")
        kw = dict(superclass_wnids=["n00015388", "n04524313"])
        n_test = 10
        if mode == "dataset_test":
            kw["dataset_test"] = "CIFAR100"
            n_test = 100
    j = getattr(ja, name)(tree=jtree, **kw)
    t = getattr(ta, name)(tree=ttree, device="cpu", **kw)
    np.testing.assert_array_equal(t.mapping_pred, j.mapping_pred)
    np.testing.assert_array_equal(t.mapping_target, j.mapping_target)
    rng = np.random.RandomState(5)
    C = len(ttree.wnids_leaves)
    batches = [(rng.randn(40, C).astype(np.float32), rng.randint(0, n_test, 40))
               for _ in range(3)]
    for logits, targets in batches:
        for got, want in zip(t.forward(logits, targets), j.forward(logits, targets)):
            np.testing.assert_array_equal(got, want)
    for an in (j, t):
        an.start_test(0)
        for logits, targets in batches:
            an.update_batch(logits, targets)
        an.end_test(0)
    assert (t.correct, t.total, t.accuracy) == (j.correct, j.total, j.accuracy)
    assert t.total > 0
    if mode == "dataset_test":  # 44 of CIFAR100's classes are animals or vehicles
        assert (t.mapping_target >= 0).sum() == 44 and (t.mapping_pred >= 0).sum() == 8


def test_visualize_hierarchy_inference_writes_jax_pages(tmp_path):
    """VisualizeHierarchyInference writes, per sample up to its limit, the
    page that JAX's writes: the decision path highlighted with its edge
    probabilities."""
    import nbdt_tpu.analysis as ja

    import nbdt_torch.analysis as ta

    jtree, ttree = tree_pair("CIFAR10")
    j = ja.VisualizeHierarchyInference(tree=jtree, out_dir=str(tmp_path / "jax"), limit=5)
    t = ta.VisualizeHierarchyInference(tree=ttree, out_dir=str(tmp_path / "port"), limit=5,
                                       device="cpu")
    rng = np.random.RandomState(2)
    batches = [(rng.randn(3, 10).astype(np.float32) * 3, rng.randint(0, 10, 3))
               for _ in range(3)]
    for an in (j, t):
        _run(an, batches, train=False)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 5
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


def _args(name, tree):
    return argparse.Namespace(analysis=name, superclass_wnids=[tree.wnids_leaves[0]],
                              visualize_decision_node_wnid=tree.wnids_leaves[0],
                              dataset="CIFAR10", dataset_test=None, save_k=3)


def test_build_analyzer_constructs_every_ported_analyzer():
    """Every analyzer builds through the CLI's build_analyzer with the live
    tree and the run's device (mirrors tests/test_analysis.py's JAX check):
    none is left to port; the superclass pair takes --superclass-wnids and
    keeps the host loop, and VisualizeHierarchyInference its rules."""
    import nbdt_tpu.analysis as ja

    import nbdt_torch.analysis as ta
    from nbdt_torch.main import build_analyzer, main

    _, tree = tree_pair("synthetic")

    class DS:
        classes = tree.classes

    assert ta.names == ja.names and len(ta.names) == 14
    assert ta.NOT_PORTED == {}
    for name in ta.names:
        an = build_analyzer(_args(name, tree), tree, DS(), torch.device("cpu"))
        assert type(an).__name__ == name
        if hasattr(an, "rules"):
            assert an.rules.tree is tree and an.rules.device.type == "cpu"
        if isinstance(an, ta.ScoreSave):
            assert an.k == 3
        if isinstance(an, ta.Superclass):
            assert an.superclass_wnids == [tree.wnids_leaves[0]] and an.device_eval() is None
            assert an.rules_test is an.rules


def _tiny_wrn_jax(num_classes=10, dtype=None):
    from nbdt_tpu.models.wideresnet import WRN

    return WRN(depth=10, width=2, num_classes=num_classes)


def _tiny_wrn_port(num_classes=10, dtype=torch.float32):
    from nbdt_torch.models import WRN

    return WRN(10, 2, num_classes, dtype=dtype)


def test_cli_eval_checkpoint_analysis_matches_jax(tmp_path, monkeypatch, capsys):
    """A tiny WRN registered under one name in both packages: both CLIs load
    the same .pth with --checkpoint-path and print the same backbone and
    NBDT-Soft accuracies under --eval --analysis SoftEmbeddedDecisionRules."""
    import nbdt_tpu.main as jmain
    import nbdt_tpu.models as jmodels
    import nbdt_tpu.models.convert as jconvert
    from test_torch_wrn import wrn_pair

    import nbdt_torch.main as tmain
    import nbdt_torch.models as tmodels

    name = "wrn10_2_test"
    _, _, port = wrn_pair(32)
    path = tmp_path / "tiny.pth"
    torch.save(port.state_dict(), path)
    monkeypatch.setitem(tmodels.MODEL_REGISTRY, name, _tiny_wrn_port)
    monkeypatch.setitem(jconvert._ARCH_MAPPERS, name, jconvert._wrn_key_to_path)
    jmodels.register_model(name, _tiny_wrn_jax)
    args = ["--synthetic", "--dataset", "CIFAR10", "--arch", name, "--batch-size", "16",
            "--hierarchy", "induced-wrn28_10_cifar10", "--eval", "--checkpoint-path", str(path),
            "--analysis", "SoftEmbeddedDecisionRules", "--no-progress",
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    try:
        jacc = jmain.main(args)
    finally:
        jmodels.MODEL_REGISTRY.pop(name)
    jout = capsys.readouterr().out
    tacc = tmain.main(args + ["--device", "cpu"])
    tout = capsys.readouterr().out
    assert "Loaded pretrained weights" in tout
    line = re.compile(r"\[NBDT-Soft\] Accuracy: .*")
    assert line.findall(tout) == line.findall(jout) and len(line.findall(tout)) == 1
    assert tacc == jacc


@pytest.mark.parametrize("analysis,label", [("Superclass", "Superclass"),
                                            ("SuperclassNBDT", "Superclass-NBDT")])
def test_cli_zero_shot_eval_matches_jax(tmp_path, monkeypatch, capsys, analysis, label):
    """Both CLIs' zero-shot eval of one tiny WRN .pth trained without cat
    and dog: CIFAR100's synthetic test set scored in the superclass space of
    'animal' and 'vehicle' through the merged mini-corpus prints the same
    correct/total, and the accuracy is the run's score."""
    import json

    import nbdt_tpu.main as jmain
    import nbdt_tpu.models as jmodels
    import nbdt_tpu.models.convert as jconvert
    from nbdt_tpu.hierarchy import wnid as jwnid
    from test_torch_wrn import wrn_pair

    import nbdt_torch.main as tmain
    import nbdt_torch.models as tmodels
    from nbdt_torch.hierarchy import wnid as twnid

    name = "wrn10_2_test"
    _, _, port = wrn_pair(32)
    path = tmp_path / "tiny.pth"
    torch.save(port.state_dict(), path)
    table = tmp_path / "corpus.json"
    table.write_text(json.dumps(_corpus_table()))
    monkeypatch.setitem(tmodels.MODEL_REGISTRY, name, _tiny_wrn_port)
    monkeypatch.setitem(jconvert._ARCH_MAPPERS, name, jconvert._wrn_key_to_path)
    jmodels.register_model(name, _tiny_wrn_jax)
    args = ["--synthetic", "--dataset", "CIFAR10", "--arch", name, "--batch-size", "16",
            "--hierarchy", "wordnet", "--eval", "--checkpoint-path", str(path),
            "--exclude-labels", "3", "5", "--dataset-test", "CIFAR100", "--disable-test-eval",
            "--analysis", analysis, "--superclass-wnids", "n00015388", "n04524313",
            "--mini-corpus", str(table), "--no-progress", "--checkpoint-dir", str(tmp_path)]
    from nbdt_torch.analysis import Superclass
    from nbdt_torch.assets import get_dataset_wnids
    from nbdt_torch.data import SyntheticDataset

    try:
        jacc = jmain.main(args)
        jout = capsys.readouterr().out
        tacc = tmain.main(args + ["--device", "cpu"])
        tout = capsys.readouterr().out
        mapping, _ = Superclass.build_mapping(get_dataset_wnids("CIFAR100"),
                                              ["n00015388", "n04524313"])
    finally:
        jmodels.MODEL_REGISTRY.pop(name)
        jwnid.clear_mini_corpus()
        twnid.clear_mini_corpus()
    line = re.compile(rf"\[{label}\] Accuracy: [\d.]+%, (\d+)/(\d+)")
    assert line.findall(tout) == line.findall(jout) and len(line.findall(tout)) == 1
    assert tacc == jacc and "Mapped 8 classes" in tout
    # the CIFAR100 test samples whose class maps to a superclass
    labels = SyntheticDataset(100, size=32, seed=1).labels
    assert int(line.findall(tout)[0][1]) == int((mapping[labels] >= 0).sum())


def test_cli_trains_and_evaluates_wrn_on_tinyimagenet(tmp_path, monkeypatch, capsys):
    """The slice's CLI path at a tiny size on the CPU: synthetic 64px
    TinyImagenet200 data, a tiny WRN on the vendored induced-wrn28_10 tree,
    HardTreeSupLoss with the HardEmbeddedDecisionRules analyzer for one
    epoch, then --eval of the .pth it wrote with SoftEmbeddedDecisionRules.
    --pretrained alone looks the arch up in the released-checkpoint tables,
    which hold no such arch."""
    import nbdt_torch.main as tmain
    import nbdt_torch.models as tmodels

    name = "wrn10_2_test"
    monkeypatch.setitem(tmodels.MODEL_REGISTRY, name, _tiny_wrn_port)
    base = ["--synthetic", "--dataset", "TinyImagenet200", "--arch", name,
            "--hierarchy", "induced-wrn28_10", "--batch-size", "8", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path), "--no-progress"]
    tmain.main(base + ["--loss", "HardTreeSupLoss", "--analysis", "HardEmbeddedDecisionRules",
                       "--epochs", "1"])
    out = capsys.readouterr().out
    assert re.search(r"\[NBDT-Hard\] Accuracy: [\d.]+%, \d+/16 ", out)
    pth = tmp_path / f"ckpt-TinyImagenet200-{name}-induced-wrn28_10-HardTreeSupLoss-last.pth"
    assert pth.exists()
    acc = tmain.main(base + ["--eval", "--checkpoint-path", str(pth),
                             "--analysis", "SoftEmbeddedDecisionRules"])
    out = capsys.readouterr().out
    assert "Loaded pretrained weights" in out and 0 <= acc <= 100
    assert re.search(r"\[NBDT-Soft\] Accuracy: [\d.]+%, \d+/16 ", out)
    with pytest.raises(KeyError, match="No pretrained checkpoint"):
        tmain.main(base + ["--pretrained"])
