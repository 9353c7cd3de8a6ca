"""nbdt_torch.losses against nbdt_tpu.losses on the same logits: each
loss's value, and its gradient with respect to the logits against
``jax.grad``, on the synthetic tree, the vendored CIFAR10, CIFAR100,
TinyImagenet200 and Imagenet1000 induced graphs, the CIFAR100 WordNet graph
(up to 8 children a node) and a multi-path DAG; the port's losses are also
held to ``tests/oracle.py`` as ``tests/test_losses.py`` holds the JAX ones.

Tolerances: values rtol 1e-5 (f32, sums in another order); gradients
atol 1e-7 + rtol 1e-4 of their largest entry (per-element gradients of a
mean over the batch are small, and the soft loss re-softmaxes a product of
probabilities, so relative error grows where entries are tiny).
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_port import tree_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)

TREES = ["synthetic", "CIFAR10", "CIFAR100", "TinyImagenet200", "Imagenet1000",
         "CIFAR100-wordnet", "dag"]


@functools.lru_cache(maxsize=None)
def _pair(name):
    import nbdt_tpu.rules as jr

    import nbdt_torch.rules as tr

    jtree, ttree = tree_pair(name)
    return jtree, ttree, jr.to_device_tree(jtree.arrays), tr.to_device_tree(ttree.arrays, "cpu")


def _batch(C, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, C) * 2).astype(np.float32), rng.randint(0, C, batch).astype(np.int32)


def _smoothed_ce(xp, eps=0.2):
    """Label-smoothing CE in either framework (``xp`` = jax.numpy or torch)."""
    if xp is torch:
        def ce(logits, targets):
            logp = torch.log_softmax(logits.float(), -1)
            onehot = torch.nn.functional.one_hot(targets.long(), logits.shape[-1]).float()
            return -((onehot * (1 - eps) + eps / logits.shape[-1]) * logp).sum(-1).mean()
    else:
        import jax

        def ce(logits, targets):
            logp = jax.nn.log_softmax(logits.astype(xp.float32), axis=-1)
            onehot = jax.nn.one_hot(targets, logits.shape[-1])
            return -((onehot * (1 - eps) + eps / logits.shape[-1]) * logp).sum(-1).mean()
    return ce


# name: (JAX fn(logits, targets, jt), port fn(logits, targets, jt))
def _loss_fns():
    import nbdt_tpu.losses as jl
    import jax.numpy as jnp

    import nbdt_torch.losses as tl

    return {
        "cross_entropy": (lambda x, y, jt: jl.cross_entropy(x, y),
                          lambda x, y, jt: tl.cross_entropy(x, y)),
        "soft_tree_sup_loss": (jl.soft_tree_sup_loss, tl.soft_tree_sup_loss),
        "hard_tree_sup_loss": (lambda x, y, jt: jl.hard_tree_sup_loss(x, y, jt, 10.0),
                               lambda x, y, jt: tl.hard_tree_sup_loss(x, y, jt, 10.0)),
        "hard_tree_sup_loss_custom": (
            lambda x, y, jt: jl.hard_tree_sup_loss_custom(x, y, jt, _smoothed_ce(jnp), 1.5),
            lambda x, y, jt: tl.hard_tree_sup_loss_custom(x, y, jt, _smoothed_ce(torch), 1.5)),
        "soft_seg_tree_sup_loss": (
            lambda x, y, jt: jl.soft_seg_tree_sup_loss(x, jnp.where(y % 5 == 0, -1, y), jt),
            lambda x, y, jt: tl.soft_seg_tree_sup_loss(x, torch.where(y % 5 == 0, -1, y), jt)),
    }


LOSSES = ["cross_entropy", "soft_tree_sup_loss", "hard_tree_sup_loss",
          "hard_tree_sup_loss_custom", "soft_seg_tree_sup_loss"]


# The JAX custom hard loss compiles one vmap per child count: the WordNet
# graph's eight counts cost 12 s, so it takes the binary trees and the K=3
# synthetic tree only.
CASES = [(name, loss) for name in TREES for loss in LOSSES
         if not (name == "CIFAR100-wordnet" and loss == "hard_tree_sup_loss_custom")]


@pytest.mark.parametrize("name,loss", CASES)
def test_loss_and_grad_match_jax(name, loss):
    import jax
    import jax.numpy as jnp

    _, ttree, jjt, tjt = _pair(name)
    jfn, tfn = _loss_fns()[loss]
    x, y = _batch(ttree.arrays.num_classes, seed=len(name))
    jval, jgrad = jax.value_and_grad(lambda l: jfn(l, jnp.asarray(y), jjt))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tval = tfn(tx, torch.as_tensor(y).long(), tjt)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tx.grad.numpy(), jgrad, rtol=1e-4,
                               atol=1e-7 + 1e-4 * np.abs(jgrad).max())


@pytest.mark.parametrize("name", ["synthetic", "CIFAR10", "dag"])
def test_wrappers_match_jax(name):
    """The class API: total = xent * xw + tree * tw with schedules, for every
    loss class, custom criteria included; SoftTreeLoss before its start epoch
    is criterion * (xw + tw)."""
    import jax.numpy as jnp

    import nbdt_tpu.losses as jl
    import nbdt_torch.losses as tl

    jtree, ttree, _, _ = _pair(name)
    x, y = _batch(ttree.arrays.num_classes, seed=3)
    cases = [
        ("SoftTreeSupLoss", {}),
        ("HardTreeSupLoss", {"tree_supervision_weight": 2.0}),
        ("SoftTreeSupLoss", {"tree_supervision_weight": 1.0, "tree_supervision_weight_end": 3.0,
                             "xent_weight_end": 0.5}),
        ("SoftTreeLoss", {"tree_start_epochs": 5}),
    ]
    for cls, kw in cases:
        for custom in (False, True):
            jkw = dict(kw, criterion=_smoothed_ce(jnp)) if custom else kw
            tkw = dict(kw, criterion=_smoothed_ce(torch)) if custom else kw
            j = getattr(jl, cls)(tree=jtree, **jkw)
            t = getattr(tl, cls)(tree=ttree, device="cpu", **tkw)
            for epoch in (0, 4):
                j.set_epoch(epoch, 10)
                t.set_epoch(epoch, 10)
                np.testing.assert_allclose(float(t(x, y)), float(j(x, y)), rtol=1e-5,
                                           err_msg=f"{cls} {kw} custom={custom} epoch={epoch}")
    jce, tce = jl.CrossEntropyLoss(), tl.CrossEntropyLoss(device="cpu")
    np.testing.assert_allclose(float(tce(x, y)), float(jce(x, y)), rtol=1e-6)


def test_seg_wrapper_matches_jax():
    import nbdt_tpu.losses as jl
    import nbdt_torch.losses as tl

    jtree, ttree, _, _ = _pair("synthetic")
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 4, 7).astype(np.float32)
    y = rng.randint(-1, 7, size=(2, 4, 4)).astype(np.int32)
    j = jl.SoftSegTreeSupLoss(tree=jtree, ignore_label=-1)
    t = tl.SoftSegTreeSupLoss(tree=ttree, ignore_label=-1, device="cpu")
    np.testing.assert_allclose(float(t(x, y)), float(j(x, y)), rtol=1e-5)


@pytest.mark.parametrize("name", ["synthetic", "CIFAR10", "CIFAR100-wordnet"])
def test_losses_match_oracle(name):
    """The reference's per-node loops (tests/oracle.py, f64): CE, the soft
    loss and the bucketed hard loss at tsw 1 and 10."""
    from oracle import (oracle_cross_entropy, oracle_hard_tree_sup_loss,
                        oracle_soft_tree_sup_loss)

    import nbdt_torch.losses as tl

    _, ttree, _, tjt = _pair(name)
    x, y = _batch(ttree.arrays.num_classes, batch=24, seed=5)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y).long()
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(float(tl.cross_entropy(tx, ty)), oracle_cross_entropy(x64, y),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tl.soft_tree_sup_loss(tx, ty, tjt)),
                               oracle_soft_tree_sup_loss(x64, y, ttree), rtol=5e-4)
    for tsw in (1.0, 10.0):
        np.testing.assert_allclose(
            float(tl.HardTreeSupLoss(tree=ttree, tree_supervision_weight=tsw,
                                     device="cpu").forward_tree(tx, ty)),
            oracle_hard_tree_sup_loss(x64, y, ttree, tree_supervision_weight=tsw), rtol=5e-4)


def test_scheduled_weight_and_names():
    import nbdt_tpu.losses as jl
    import nbdt_torch.losses as tl

    assert tl.names == jl.names
    for args in ((1.0, 3.0, 0.5), (1.0, 3.0, 0.25, 2.0), (2.0, 2.0, 1.0)):
        assert tl.scheduled_weight(*args) == jl.scheduled_weight(*args)


def test_nbdt_output_refused():
    from nbdt_torch.losses import SoftTreeSupLoss, assert_output_not_nbdt
    from nbdt_torch.model import TaggedOutput

    _, ttree, _, _ = _pair("synthetic")
    x = torch.randn(2, 7)
    assert_output_not_nbdt(x)
    with pytest.raises(AssertionError, match="NBDT model's output"):
        SoftTreeSupLoss(tree=ttree, device="cpu")(TaggedOutput(x), torch.zeros(2).long())


def test_soft_tree_loss_without_model_fn_raises_at_refresh():
    from nbdt_torch.losses import SoftTreeLoss

    _, ttree, _, _ = _pair("synthetic")
    crit = SoftTreeLoss(tree=ttree, tree_start_epochs=2, tree_update_every_epochs=2,
                        device="cpu")
    crit.set_epoch(1, 10)  # before the start: no refresh due
    with pytest.raises(RuntimeError, match="model_fn"):
        crit.set_epoch(2, 10)


class _PrecisionSpy(torch.utils._python_dispatch.TorchDispatchMode):
    """Records (operand shapes, float32 matmul precision) of every matrix
    product dispatched while it is active, forward and backward."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            self.calls.append((shapes, torch.get_float32_matmul_precision()))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("loss", ["soft_tree_sup_loss", "hard_tree_sup_loss"])
def test_tree_matmuls_stay_exact_f32_in_backward(loss):
    """Under a process-wide "medium" precision (TF32 for a backbone), every
    product that touches the tree's N*K slots runs at "highest", in the
    forward and in the backward; the precision is restored after."""
    import nbdt_torch.losses as tl

    _, ttree, _, tjt = _pair("CIFAR100")
    S = ttree.arrays.num_inodes * ttree.arrays.max_children
    x, y = _batch(ttree.arrays.num_classes, batch=12)
    tx = torch.tensor(x, requires_grad=True)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        spy = _PrecisionSpy()
        with spy:
            getattr(tl, loss)(tx, torch.as_tensor(y).long(), tjt).backward()
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    tree = [p for shapes, p in spy.calls if any(S in s for s in shapes)]
    # node logits (forward + the logits' gradient), and for the soft loss the
    # path sum (forward + the log-probs' gradient)
    assert len(tree) == (4 if loss == "soft_tree_sup_loss" else 2), spy.calls
    assert set(tree) == {"highest"}
