"""nbdt_torch.rules against nbdt_tpu.rules on the same logits.

Leaf log-probs agree within 1e-5 (f32, sums in another order); predictions,
node predictions and decision-path wnids are equal. Leaf outputs are
compared in log space, class probabilities in probability space. The port's
rules are also held to ``tests/oracle.py``, the reference's per-node loops
transcribed in numpy (f64).
"""

import numpy as np
import pytest
import torch

from test_torch_port import tree_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)

# "CIFAR100-wordnet" is the vendored WordNet graph: 49 inner nodes of up to 8
# children (every vendored graph is a tree; "dag" is the multi-path case).
TREES = ["synthetic", "CIFAR10", "CIFAR100", "TinyImagenet200", "Imagenet1000",
         "CIFAR100-wordnet", "dag"]


def _logits(ta, batch=32, seed=0):
    return np.random.RandomState(seed).randn(batch, ta.num_classes).astype(np.float32)


def _both(name, fn_name):
    import jax.numpy as jnp

    import nbdt_tpu.rules as jr
    import nbdt_torch.rules as tr

    jtree, ttree = tree_pair(name)
    logits = _logits(ttree.arrays)
    j = getattr(jr, fn_name)(jnp.asarray(logits), jr.to_device_tree(jtree.arrays))
    t = getattr(tr, fn_name)(torch.as_tensor(logits),
                             tr.to_device_tree(ttree.arrays, "cpu"))
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: v.numpy() for k, v in t.items()}, ttree.arrays)


@pytest.mark.parametrize("name", TREES)
def test_soft_outputs_match(name):
    j, t, ta = _both(name, "soft_outputs")
    np.testing.assert_allclose(t["leaf_log_probs"], j["leaf_log_probs"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t["class_probs"], j["class_probs"], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(t["preds"], j["preds"])
    np.testing.assert_array_equal(t["node_preds"], j["node_preds"])
    valid = ta.child_mask[None]
    np.testing.assert_allclose(np.where(valid, t["node_log_probs"], 0),
                               np.where(valid, j["node_log_probs"], 0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t["node_entropy"], j["node_entropy"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", TREES)
def test_hard_outputs_match(name):
    j, t, _ = _both(name, "hard_outputs")
    np.testing.assert_array_equal(t["preds"], j["preds"])
    np.testing.assert_array_equal(t["node_preds"], j["node_preds"])
    np.testing.assert_array_equal(t["logits"], j["logits"])


@pytest.mark.parametrize("kind", ["Soft", "Hard"])
@pytest.mark.parametrize("name", ["CIFAR10", "dag"])
def test_forward_with_decisions_match(kind, name):
    import nbdt_tpu.rules as jr
    import nbdt_torch.rules as tr

    jtree, ttree = tree_pair(name)
    logits = _logits(ttree.arrays, batch=8, seed=1)
    jout, jdec = getattr(jr, f"{kind}EmbeddedDecisionRules")(tree=jtree).forward_with_decisions(logits)
    tout, tdec = getattr(tr, f"{kind}EmbeddedDecisionRules")(
        tree=ttree, device="cpu").forward_with_decisions(logits)
    assert tout._nbdt_output_flag
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-7)
    assert len(jdec) == len(tdec)
    for a, b in zip(jdec, tdec):
        assert [s["node"].wnid for s in a] == [s["node"].wnid for s in b]
        assert [s["name"] for s in a] == [s["name"] for s in b]
        np.testing.assert_allclose([s["prob"] for s in b], [s["prob"] for s in a], rtol=1e-5)


def test_forward_nodes_match():
    import nbdt_tpu.rules as jr
    import nbdt_torch.rules as tr

    jtree, ttree = tree_pair("synthetic")
    logits = _logits(ttree.arrays)
    j = jr.SoftEmbeddedDecisionRules(tree=jtree).forward_nodes(logits)
    t = tr.SoftEmbeddedDecisionRules(tree=ttree, device="cpu").forward_nodes(logits)
    assert list(j) == list(t)
    for wnid in j:
        np.testing.assert_array_equal(t[wnid]["preds"], j[wnid]["preds"])
        np.testing.assert_allclose(t[wnid]["probs"], j[wnid]["probs"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["CIFAR100", "dag"])
def test_hard_walk_matches_closed_form(name):
    import nbdt_torch.rules as tr

    _, ttree = tree_pair(name)
    jt = tr.to_device_tree(ttree.arrays, "cpu")
    outs = tr.get_all_node_outputs(torch.as_tensor(_logits(ttree.arrays, 64)), jt)
    closed = tr.hard_traverse(outs.preds, jt._replace(is_multipath=False))
    walk = tr.hard_traverse_scan(outs.preds, jt)
    if name == "dag":  # the closed form is wrong on DAGs; the dispatch takes the walk
        torch.testing.assert_close(tr.hard_traverse(outs.preds, jt), walk)
    else:
        torch.testing.assert_close(closed, walk)


@pytest.mark.parametrize("name", TREES)
def test_rules_match_oracle(name):
    """Soft leaf probabilities, per-node probabilities and the hard walk of
    the port against the oracle's loops over the tree's nodes."""
    from oracle import oracle_all_node_outputs, oracle_hard_traverse, oracle_soft_traverse

    import nbdt_torch.rules as tr

    _, ttree = tree_pair(name)
    logits = _logits(ttree.arrays, batch=16, seed=2)
    jt = tr.to_device_tree(ttree.arrays, "cpu")
    soft = tr.soft_outputs(torch.as_tensor(logits), jt)
    want = oracle_soft_traverse(logits.astype(np.float64), ttree)
    np.testing.assert_allclose(soft["class_probs"].numpy(), want, rtol=1e-4, atol=1e-7)
    nodes = oracle_all_node_outputs(logits.astype(np.float64), ttree)
    for i, node in enumerate(ttree.inodes):
        k = node.num_classes
        np.testing.assert_allclose(soft["node_probs"][:, i, :k].numpy(), nodes[node.wnid]["probs"],
                                   rtol=1e-5, atol=1e-6)
    if not ttree.arrays.is_multipath:  # the oracle's walk takes each node's first path
        hard = tr.hard_outputs(torch.as_tensor(logits), jt)
        np.testing.assert_array_equal(hard["preds"].numpy(), oracle_hard_traverse(logits, ttree))
