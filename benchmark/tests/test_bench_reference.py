"""The benchmark's plain reference against the program at tiny sizes on
the CPU: the soft rules and decision paths on every configuration's
vendored tree, every serving cell's backbone from one state dict, one
SoftTreeSupLoss SGD step, and the seeded weights of a reference whose
classifier is a 1x1 convolution."""

import copy

import pytest
import torch

from bench_testlib import CONFIGS, cells_of_kind, tiny_cell
from benchmark import cells, harness
from benchmark.reference import train as ref_train
from benchmark.reference.tree import SoftRules, hierarchy


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", CONFIGS)
def test_soft_rules_and_paths_match_the_program(name):
    from nbdt_torch.rules import SoftEmbeddedDecisionRules
    from nbdt_torch.ops.soft_traversal import fused_soft_head, prepare_head_constants

    config = cells.load_json(cells.BENCH / "configs" / f"{name}.json")
    ctx = harness.Context(name, {"params": {}}, config, 3, "cpu")
    tree = ctx.program_tree()
    rules = SoftRules(hierarchy(config), "cpu")
    assert rules.h.wnids == list(tree.wnids_leaves)
    C = len(rules.h.wnids)
    logits = 3 * torch.randn(64, C, generator=torch.Generator().manual_seed(1))
    mine = SoftEmbeddedDecisionRules(tree=tree, device="cpu")
    want, paths, gap = rules.decisions(logits)
    got, decisions = mine.forward_with_decisions(logits)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    for b in range(64):
        steps = [(s["node"].wnid, s["prob"], s["entropy"]) for s in decisions[b]]
        if gap[b] > 1e-4:
            assert [s[0] for s in steps] == [s[0] for s in paths[b]]
            for (_, p1, e1), (_, p2, e2) in zip(steps, paths[b]):
                assert abs(p1 - p2) < 1e-5 and abs(e1 - e2) < 1e-5
    # the fused head's plain version, on features and a classifier
    D = 32
    feats, W = torch.randn(64, D), torch.randn(D, C) / D ** 0.5
    hc = prepare_head_constants(tree.arrays, W.numpy(), None, device="cpu")
    (leaf,) = fused_soft_head(feats, hc, want_aux=False)
    assert torch.allclose(leaf.exp(), rules.probs(feats @ W), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("workload", cells_of_kind("closed_loop"))
def test_backbones_match_the_program(workload):
    _, cell, config = tiny_cell(workload)
    ctx = harness.Context(workload, cell, config, 4, "cpu")
    ref, program = ctx.reference(), ctx.program_model().eval()
    x = ctx.images(4, "probe").permute(0, 3, 1, 2)
    with torch.no_grad():
        want = ref(x)
        got = program(x.contiguous(memory_format=torch.channels_last))
    assert want.std(0).mean() > 0.1, "calibrated logits differ between images"
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_one_sgd_step_matches_the_program():
    _, cell, config = tiny_cell("resnet18_cifar10.train")
    cell["params"]["checked_steps"] = 1
    kind = harness.load_module(cells.BENCH / "traffic" / "train_steps.py")
    ctx = harness.Context("resnet18_cifar10.train", cell, config, 6, "cpu")
    state = kind.setup(ctx)
    p, opt = cell["params"], config["train"]
    ref = ref_train.SoftTreeSupSGD(copy.deepcopy(ctx.reference()), ctx.rules(), opt["lr"],
                                   opt["momentum"], opt["weight_decay"])
    gen = torch.Generator()
    gen.set_state(state["aug_start"])
    offsets, flips = ref_train.draws(gen, p["batch"], p["crop_pad"])
    x, y = ref_train.batch(state["images"], state["labels"], state["perm_start"][:p["batch"]],
                           offsets, flips, p["crop_pad"], config["normalize"]["mean"],
                           config["normalize"]["std"])
    loss, grads = ref.step(x, y)
    assert abs(state["losses"][0] - float(loss)) <= 1e-6 * float(loss)
    # On the CPU a channels-last convolution's weight gradient (the program's
    # layout) differs from a contiguous one's by up to 0.6% of its largest
    # element at this batch, so each leaf is held by its norm and direction.
    for name, g in grads.items():
        mine = state["grads"][name]
        assert abs(float(mine.norm()) - float(g.norm())) <= 1e-2 * float(g.norm()), name
        assert float(torch.nn.functional.cosine_similarity(mine.flatten(), g.flatten(),
                                                           dim=0)) > 0.999, name
    for name, w in ref.params.items():
        change, want = state["p_after"][name] - state["p0"][name], w.detach() - state["p0"][name]
        assert float((change - want).norm()) <= 1e-2 * float(want.norm()), name


def test_a_classifier_of_any_shape_is_calibrated():
    """A 1x1-convolution classifier over one feature row a pixel takes the
    draws a matrix would, reshaped: per-pixel logits that differ between
    pixels and centre on nought."""
    _, cell, config = tiny_cell("resnet18_cifar10.offline")
    config.update(reference="bench_testlib:PixelNet")
    config["model"].update(num_classes=10, feature_dim=16, image_size=8)
    ctx = harness.Context("pixels", cell, config, 5, "cpu")
    model = ctx.reference()
    assert model.classifier.weight.shape == (10, 16, 1, 1)
    x = ctx.images(4, "probe").permute(0, 3, 1, 2)
    with torch.no_grad():
        logits = model(x).permute(0, 2, 3, 1).reshape(-1, 10)
    assert logits.std(0).mean() > 0.5
    assert logits.mean(0).abs().max() < 0.5 * logits.std(0).mean()
